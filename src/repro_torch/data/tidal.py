"""Tidal data (paper Sec. 3b: Woods Hole, MA mean-sea-level series).

Counterpart of ``repro/data/tidal.py``: :func:`woods_hole_like` generates
a series with the real tidal constituent periods (the ~12.4 h principal
lunar semidiurnal tide and the ~24-25 h diurnal inequality) on the
paper's two-hour cadence over one or six lunar months (n = 328 / 1968);
:func:`drop_random_hours` makes a gappy (near-grid) record of it;
:func:`load_noaa_csv` reads a real NOAA export (numpy, no file in the
repo).  Every draw goes through :mod:`repro_torch.random`.
``device=None`` means the card.
"""

from __future__ import annotations

import csv
import math

import numpy as np
import torch

from .. import random as rnd
from .._device import resolve_device
from .synthetic import Dataset

LUNAR_MONTH_H = 27.321661 * 24.0     # sidereal month in hours
SAMPLE_EVERY_H = 2.0                 # paper: two-hour sampling

# Principal tidal constituents (period [h], relative amplitude at Woods Hole)
CONSTITUENTS = (
    ("M2", 12.4206012, 1.00),   # principal lunar semidiurnal
    ("S2", 12.0000000, 0.22),   # principal solar semidiurnal
    ("N2", 12.6583475, 0.24),   # larger lunar elliptic semidiurnal
    ("K1", 23.9344721, 0.14),   # lunisolar diurnal
    ("O1", 25.8193417, 0.11),   # lunar diurnal
)


def woods_hole_like(key, months: int = 6, noise: float = 0.01,
                    dtype=torch.float64, device=None) -> Dataset:
    """Woods-Hole-like series; months=1 -> n=328, months=6 -> n=1968."""
    dev = resolve_device(device)
    n = int(round(months * LUNAR_MONTH_H / SAMPLE_EVERY_H))
    t = torch.arange(n, dtype=dtype, device=dev) * SAMPLE_EVERY_H
    keys = rnd.split(key, len(CONSTITUENTS) + 1)
    y = torch.zeros(n, dtype=dtype, device=dev)
    for (_, period, amp), k in zip(CONSTITUENTS, keys[:-1]):
        phase = rnd.uniform(k, (), device=dev, dtype=dtype) * 2 * math.pi
        y = y + amp * torch.sin(2 * math.pi * t / period + phase)
    # slow lunar-cycle envelope (spring/neap modulation) + measurement noise
    y = y * (1.0 + 0.25 * torch.sin(2 * math.pi * t / (LUNAR_MONTH_H / 2)))
    y = y + noise * rnd.normal(keys[-1], (n,), device=dev, dtype=dtype)
    y = y - torch.mean(y)
    return Dataset(x=t, y=y, sigma_n=noise)


def drop_random_hours(ds: Dataset, frac: float, key) -> Dataset:
    """Drop each sample with probability ``frac`` (tide-gauge outages, the
    paper's footnote 7): the survivors stay on the cadence, a near grid.
    Keeps at least two points."""
    n = int(ds.x.shape[0])
    keep = (rnd.uniform(key, (n,), device="cpu", dtype=torch.float64)
            >= frac).numpy().copy()
    if keep.sum() < 2:
        keep[:2] = True
    idx = torch.as_tensor(np.where(keep)[0], device=ds.x.device)
    return Dataset(x=ds.x[idx], y=ds.y[idx], sigma_n=ds.sigma_n)


def load_noaa_csv(path: str, dtype=torch.float64, device=None) -> Dataset:
    """A NOAA tides-and-currents water-level CSV (``Date Time, Water Level,
    ...`` columns; the paper's station is Woods Hole, 8447930): hours since
    the first sample, levels with the mean removed, sigma_n = 0.01."""
    dev = resolve_device(device)
    times, levels = [], []
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        t_col = 0
        wl_col = 1
        for i, h in enumerate(header):
            hl = h.strip().lower()
            if "date" in hl:
                t_col = i
            if "water level" in hl or hl == "wl":
                wl_col = i
        t0 = None
        for row in reader:
            if not row or not row[wl_col].strip():
                continue
            ts = np.datetime64(row[t_col].strip().replace(" ", "T"))
            if t0 is None:
                t0 = ts
            times.append((ts - t0) / np.timedelta64(1, "h"))
            levels.append(float(row[wl_col]))
    y = np.asarray(levels)
    y = y - y.mean()
    return Dataset(x=torch.as_tensor(np.asarray(times), dtype=dtype,
                                     device=dev),
                   y=torch.as_tensor(y, dtype=dtype, device=dev),
                   sigma_n=0.01)
