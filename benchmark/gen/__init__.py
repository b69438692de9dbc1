"""Traffic generators: each reads a traffic file's parameters and a seed."""
