"""Dataset generators (numpy)."""
