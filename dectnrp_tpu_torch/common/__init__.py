"""Common infrastructure of the port (see dectnrp_tpu/common): the batched
JSON record export (`json_export.py`), the native host runtime's bindings
(`native.py`) and the live-IQ TCP scope (`tcp_scope.py`)."""
