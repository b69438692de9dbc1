"""Per-peer contact registry (reference lib/src/mac/contact_list/).

Tracks identities, association state and per-contact MAC state (allocation
view, feedback plan, MIMO CSI) for FT and PT firmwares.

Copy of `dectnrp_tpu/mac/contact_list.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..sections.part4.identity import Identity


@dataclass
class Contact:
    identity: Identity
    associated: bool = False
    last_heard: int = -1            # global sample count
    snr_db: float = float("nan")
    mcs_dl: int = 0
    mcs_ul: int = 0
    codebook_index: int = 0
    allocation: Any = None          # AllocationPt view for this peer
    mimo_csi: Any = None
    sequence_number: int = 0

    def next_sequence_number(self) -> int:
        sn = self.sequence_number
        self.sequence_number = (sn + 1) & 0xFFF
        return sn


class ContactList:
    def __init__(self):
        self._by_srdid: dict[int, Contact] = {}
        self._by_lrdid: dict[int, Contact] = {}

    def add(self, identity: Identity) -> Contact:
        c = Contact(identity)
        self._by_srdid[identity.short_rdid] = c
        self._by_lrdid[identity.long_rdid] = c
        return c

    def remove(self, short_rdid: int) -> None:
        c = self._by_srdid.pop(short_rdid, None)
        if c is not None:
            self._by_lrdid.pop(c.identity.long_rdid, None)

    def by_short(self, short_rdid: int) -> Contact | None:
        return self._by_srdid.get(short_rdid)

    def by_long(self, long_rdid: int) -> Contact | None:
        return self._by_lrdid.get(long_rdid)

    def all(self) -> list[Contact]:
        return list(self._by_srdid.values())

    def associated(self) -> list[Contact]:
        return [c for c in self._by_srdid.values() if c.associated]

    def __len__(self) -> int:
        return len(self._by_srdid)
