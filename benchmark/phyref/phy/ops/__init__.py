"""The sync detection metric's plain twin, a frozen copy."""
