"""Batched JSON record export (reference common/json/json_export.hpp:41-68:
records are buffered `json_export_length` at a time and flushed to numbered
files <prefix>_<cnt>.json; worker_tx_rx.cpp:355-415 uses it for the
per-received-packet dumps that feed the MATLAB analysis repo).

Copy of `dectnrp_tpu/common/json_export.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

import json
import os
from typing import Any


class JsonExport:
    def __init__(self, out_dir: str, prefix: str = "records",
                 batch_len: int = 100):
        self.out_dir = out_dir
        self.prefix = prefix
        self.batch_len = batch_len
        self._buf: list[Any] = []
        self._file_cnt = 0
        self.written = 0
        os.makedirs(out_dir, exist_ok=True)

    def append(self, record: Any) -> None:
        self._buf.append(record)
        if len(self._buf) >= self.batch_len:
            self.flush()

    def flush(self) -> str | None:
        if not self._buf:
            return None
        path = os.path.join(self.out_dir,
                            f"{self.prefix}_{self._file_cnt:06d}.json")
        with open(path, "w") as f:
            json.dump(self._buf, f, indent=2, default=_np_default)
        self.written += len(self._buf)
        self._buf = []
        self._file_cnt += 1
        return path


def _np_default(o):
    import numpy as np
    if isinstance(o, np.ndarray):
        if np.iscomplexobj(o):
            return {"re": o.real.tolist(), "im": o.imag.tolist()}
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    raise TypeError(f"not JSON serializable: {type(o)}")


def packet_record(sync_report, pcc_report, snr_db: float,
                  plcf_bytes: bytes | None) -> dict:
    """Per-received-packet record (the reference's json_export content:
    radio cfg, sync_report, channel estimates, PLCF)."""
    return {
        "sync": {"time": sync_report.fine_peak_time,
                 "cfo_rad_per_sample": sync_report.cfo_rad_per_sample,
                 "N_eff_TX": sync_report.n_eff_tx,
                 "metric": sync_report.metric,
                 "rms": sync_report.rms},
        "pcc": {"crc_ok": pcc_report.crc_ok,
                "plcf_type": pcc_report.plcf_type,
                "plcf_hex": plcf_bytes.hex() if plcf_bytes else None},
        "snr_db": snr_db,
    }
