"""Upper layers of the port (see dectnrp_tpu/upper): so far the loopback
experiments (`upper/loopback.py`)."""
