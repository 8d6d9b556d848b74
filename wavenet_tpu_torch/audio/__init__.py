"""Mu-law codec."""
