"""PHY of the port: TX synthesis, STF sync, aligned RX (see dectnrp_tpu/phy)."""
