"""Channel simulation of the port (see dectnrp_tpu/simulation)."""
