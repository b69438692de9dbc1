"""The plain references that decide `correct`, and the comparison.

They run `phyref/` (a frozen plain PyTorch copy of the port's PHY, every
kernel replaced by its plain twin) and import nothing of the program.
"""
