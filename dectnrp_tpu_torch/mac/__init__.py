"""MAC helpers of the port (copies of dectnrp_tpu/mac)."""
