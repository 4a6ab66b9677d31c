"""Padded lanes no set asked for over all padded lanes (each dispatch's
bls_device_padding_waste_ratio, weighted by its B*K*M), %."""

from benchmark import readers


def read(run):
    return readers.pad_waste_pct(run)
