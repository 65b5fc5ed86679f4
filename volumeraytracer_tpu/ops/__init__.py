"""Compute ops: field preprocessing, interpolation, ray-march cores."""

from . import fields, interp, march

__all__ = ["fields", "interp", "march"]
