"""Dataset generators (numpy) and the synthetic token loader."""
from . import synthetic  # noqa: F401
