"""Native host-side helpers (the data loader's C++ library)."""
