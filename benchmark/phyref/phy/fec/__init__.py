"""Turbo codec, plain BCJR twins and PCC / PDC chains, frozen copies."""
