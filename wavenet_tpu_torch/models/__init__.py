"""Torch model core and facade."""
