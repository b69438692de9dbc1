"""Common infrastructure of the port (see dectnrp_tpu/common): so far the
batched JSON record export (`json_export.py`, a copy)."""
