"""PLCF feedback info formats 1-6, ETSI TS 103 636-4 6.2.2.

Parity: reference lib/src/sections_part4/physical_header_field/feedback_info.cpp.
Each format packs into 12 bits: low nibble of byte 0 + all of byte 1 of the
feedback region (byte 0's high nibble holds FeedbackFormat, packed by the PLCF).

Copy of `dectnrp_tpu/sections/part4/feedback_info.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

MCS_OUT_OF_RANGE = 0xFFFFFFFF

BUFFER_STATUS_LOWER = (0, 0, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                       8192, 16384, 32768, 65536, 131072)


class TxFeedback(IntEnum):
    NACK = 0
    ACK = 1
    NOT_DEFINED = -1


class MimoFeedback(IntEnum):
    SINGLE_LAYER = 0
    DUAL_LAYER = 1
    FOUR_LAYER = 2
    RESERVED = 3
    NOT_DEFINED = -1


def mcs_2_cqi(mcs: int) -> int:
    assert 0 <= mcs <= 11, "MCS undefined"
    return mcs + 1


def cqi_2_mcs(cqi: int) -> int:
    if cqi == 0 or cqi > 12:
        return MCS_OUT_OF_RANGE
    return cqi - 1


def buffer_size_2_buffer_status(size: int) -> int:
    if size == 0:
        return 0
    for s in range(1, 15):
        if size <= BUFFER_STATUS_LOWER[s + 1]:
            return s
    return 15


class FeedbackInfo:
    """Base: subclasses define fields + 12-bit pack/unpack."""

    def pack_into(self, buf: bytearray, off: int) -> None:
        raise NotImplementedError

    def is_valid(self) -> bool:
        raise NotImplementedError


@dataclass
class FeedbackF1(FeedbackInfo):
    harq_process_number: int = 0
    transmission_feedback: TxFeedback = TxFeedback.NOT_DEFINED
    buffer_size: int = 0
    mcs: int = MCS_OUT_OF_RANGE

    def is_valid(self) -> bool:
        return (0 <= self.harq_process_number <= 7
                and self.transmission_feedback != TxFeedback.NOT_DEFINED
                and buffer_size_2_buffer_status(self.buffer_size) <= 15
                and self.mcs <= 11)

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = (buf[off] & 0xF0) | (self.harq_process_number << 1) \
            | int(self.transmission_feedback)
        buf[off + 1] = (buffer_size_2_buffer_status(self.buffer_size) << 4) \
            | mcs_2_cqi(self.mcs)

    def unpack_from(self, buf, off) -> bool:
        self.harq_process_number = (buf[off] >> 1) & 0b111
        self.transmission_feedback = TxFeedback(buf[off] & 0b1)
        self.buffer_size = BUFFER_STATUS_LOWER[(buf[off + 1] >> 4) & 0b1111]
        self.mcs = cqi_2_mcs(buf[off + 1] & 0b1111)
        return self.is_valid()


@dataclass
class FeedbackF2(FeedbackInfo):
    codebook_index: int = 0
    mimo_feedback: MimoFeedback = MimoFeedback.NOT_DEFINED
    buffer_size: int = 0
    mcs: int = MCS_OUT_OF_RANGE

    def is_valid(self) -> bool:
        return (0 <= self.codebook_index <= 7
                and self.mimo_feedback in (MimoFeedback.SINGLE_LAYER,
                                           MimoFeedback.DUAL_LAYER)
                and self.mcs <= 11)

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = (buf[off] & 0xF0) | (self.codebook_index << 1) \
            | int(self.mimo_feedback)
        buf[off + 1] = (buffer_size_2_buffer_status(self.buffer_size) << 4) \
            | mcs_2_cqi(self.mcs)

    def unpack_from(self, buf, off) -> bool:
        self.codebook_index = (buf[off] >> 1) & 0b111
        self.mimo_feedback = MimoFeedback(buf[off] & 0b1)
        self.buffer_size = BUFFER_STATUS_LOWER[(buf[off + 1] >> 4) & 0b1111]
        self.mcs = cqi_2_mcs(buf[off + 1] & 0b1111)
        return self.is_valid()


@dataclass
class FeedbackF3(FeedbackInfo):
    harq_process_number_0: int = 0
    transmission_feedback_0: TxFeedback = TxFeedback.NOT_DEFINED
    harq_process_number_1: int = 0
    transmission_feedback_1: TxFeedback = TxFeedback.NOT_DEFINED
    mcs: int = MCS_OUT_OF_RANGE

    def is_valid(self) -> bool:
        return (0 <= self.harq_process_number_0 <= 7
                and self.transmission_feedback_0 != TxFeedback.NOT_DEFINED
                and 0 <= self.harq_process_number_1 <= 7
                and self.transmission_feedback_1 != TxFeedback.NOT_DEFINED
                and self.mcs <= 11)

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = (buf[off] & 0xF0) | (self.harq_process_number_0 << 1) \
            | int(self.transmission_feedback_0)
        buf[off + 1] = (self.harq_process_number_1 << 5) \
            | (int(self.transmission_feedback_1) << 4) | mcs_2_cqi(self.mcs)

    def unpack_from(self, buf, off) -> bool:
        self.harq_process_number_0 = (buf[off] >> 1) & 0b111
        self.transmission_feedback_0 = TxFeedback(buf[off] & 0b1)
        self.harq_process_number_1 = (buf[off + 1] >> 5) & 0b111
        self.transmission_feedback_1 = TxFeedback((buf[off + 1] >> 4) & 0b1)
        self.mcs = cqi_2_mcs(buf[off + 1] & 0b1111)
        return self.is_valid()


@dataclass
class FeedbackF4(FeedbackInfo):
    harq_feedback_bitmap: int = 0
    mcs: int = MCS_OUT_OF_RANGE

    def is_valid(self) -> bool:
        return 0 <= self.harq_feedback_bitmap <= 0xFF and self.mcs <= 11

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = (buf[off] & 0xF0) | (self.harq_feedback_bitmap >> 4)
        buf[off + 1] = ((self.harq_feedback_bitmap & 0b1111) << 4) \
            | mcs_2_cqi(self.mcs)

    def unpack_from(self, buf, off) -> bool:
        self.harq_feedback_bitmap = ((buf[off] & 0b1111) << 4) \
            | ((buf[off + 1] >> 4) & 0b1111)
        self.mcs = cqi_2_mcs(buf[off + 1] & 0b1111)
        return self.is_valid()


@dataclass
class FeedbackF5(FeedbackInfo):
    harq_process_number: int = 0
    transmission_feedback: TxFeedback = TxFeedback.NOT_DEFINED
    mimo_feedback: MimoFeedback = MimoFeedback.NOT_DEFINED
    codebook_index: int = 0

    def is_valid(self) -> bool:
        return (0 <= self.harq_process_number <= 7
                and self.transmission_feedback != TxFeedback.NOT_DEFINED
                and self.mimo_feedback != MimoFeedback.NOT_DEFINED
                and 0 <= self.codebook_index <= 63)

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = (buf[off] & 0xF0) | (self.harq_process_number << 1) \
            | int(self.transmission_feedback)
        buf[off + 1] = (int(self.mimo_feedback) << 6) | self.codebook_index

    def unpack_from(self, buf, off) -> bool:
        self.harq_process_number = (buf[off] >> 1) & 0b111
        self.transmission_feedback = TxFeedback(buf[off] & 0b1)
        self.mimo_feedback = MimoFeedback((buf[off + 1] >> 6) & 0b11)
        self.codebook_index = buf[off + 1] & 0b111111
        return self.is_valid()


@dataclass
class FeedbackF6(FeedbackInfo):
    harq_process_number: int = 0
    reserved: int = 0
    buffer_size: int = 0
    mcs: int = MCS_OUT_OF_RANGE

    def is_valid(self) -> bool:
        return (0 <= self.harq_process_number <= 7 and self.reserved == 0
                and self.mcs <= 11)

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = (buf[off] & 0xF0) | (self.harq_process_number << 1) \
            | self.reserved
        buf[off + 1] = (buffer_size_2_buffer_status(self.buffer_size) << 4) \
            | mcs_2_cqi(self.mcs)

    def unpack_from(self, buf, off) -> bool:
        self.harq_process_number = (buf[off] >> 1) & 0b111
        self.reserved = buf[off] & 0b1
        self.buffer_size = BUFFER_STATUS_LOWER[(buf[off + 1] >> 4) & 0b1111]
        self.mcs = cqi_2_mcs(buf[off + 1] & 0b1111)
        return self.is_valid()


_FORMAT_CLS = {1: FeedbackF1, 2: FeedbackF2, 3: FeedbackF3,
               4: FeedbackF4, 5: FeedbackF5, 6: FeedbackF6}


def pack_feedback(fmt: int, info: FeedbackInfo | None,
                  buf: bytearray, off: int) -> None:
    """Dispatch like feedback_info_pool_t::pack; fmt 0 = no feedback."""
    if fmt == 0:
        buf[off] &= 0xF0
        buf[off + 1] = 0
        return
    assert isinstance(info, _FORMAT_CLS[fmt]), "feedback format/class mismatch"
    info.pack_into(buf, off)


def unpack_feedback(fmt: int, buf, off: int):
    """Returns (info | None, ok)."""
    if fmt == 0:
        return None, (buf[off] & 0x0F) == 0 and buf[off + 1] == 0
    if fmt not in _FORMAT_CLS:
        return None, False
    info = _FORMAT_CLS[fmt]()
    return info, info.unpack_from(buf, off)
