"""Tile plans of the atomic radial kernels K1 (radial_exchange) and K2
(radial_coulomb), and the pieces of their wrappers that the two share.

Both kernels run their in-element product as band tasks
(csrc/radial_band.cuh): R rows of one tei slice times the windows of CG
density channels, over the depth nprim^2 in chunks of NU units of nprim,
with every buffer in shared memory. K1 adds cross-element tasks: the
windows of AG channels and the factors of GG multipole channels of one
element pair (csrc/radial_exchange.cu:cross_doubles). The plans mirror the
kernels' shared-memory layout (the card tests hold them to the kernels'
own count) and pick the tiles that fit two blocks on an SM, or one, so that
any nprim and channel count up to the limits named in their errors runs.
"""

import math
from typing import NamedTuple

import torch

WARPS = 8  # RB_WARPS
LDT = 20  # RX_LDT
MAX_R = 64  # 8 rows per warp
MAX_CG = 32  # RB_NT 8-column tiles
SMEM_BLOCK = 232448  # the shared memory one block may use on the H100
SMEM_TWO = 115712  # each of two blocks on one SM (228 KB, 1 KB reserved per block)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def dmma_ld(n: int) -> int:
    """csrc/dmma.cuh:dmma_ld: a row stride >= n, congruent to 4 mod 16."""
    return n + (20 - n % 16) % 16


def band_doubles(R: int, CG: int, NU: int, nprim: int) -> int:
    """csrc/radial_band.cuh:band_doubles: the staged rows and windows, or the
    partial sums of the tiles that several warps share."""
    ntb = R // 8
    return max((R + CG) * dmma_ld(_up(NU * nprim, 4)), (WARPS // ntb - 1) * ntb * 4 * 64)


def cross_doubles(AG: int, GG: int, nprim: int) -> int:
    """csrc/radial_exchange.cu:cross_doubles: the windows of AG channels, the
    factors of GG multipole channels and each warp's T tile."""
    np8 = _up(nprim, 8)
    return (AG + 2 * GG) * np8 * dmma_ld(_up(nprim, 4)) + WARPS * np8 * LDT


def fixed_bytes(nelem: int, nprim: int, nrad: int) -> int:
    """The owner table (an int4 per radial index) and gidx, staged after the
    task buffers."""
    return 4 * (4 * nrad + nelem * nprim)


class BandPlan(NamedTuple):
    R: int  # rows per band task, a multiple of 8 up to 64
    CG: int  # channels per group, a multiple of 8 up to 32
    NU: int  # depth units (of nprim) per staged chunk
    tasks: int


def band_plan(name: str, rows: int, nprim: int, ncols: int, nslices: int, fixed: int,
              nsm: int = 132, other_tasks: int = 0, other_bytes: int = 0) -> BandPlan:
    """The band tiles for `nslices` slices of `rows` rows and depth nprim^2
    against `ncols` channels, beside `other_tasks` tasks of the same kernel
    that need `other_bytes` of shared memory: within the shared memory of
    two blocks per SM if any plan fits there, else of one, the R (and the
    largest NU it admits) with the fewest staging round trips on a block
    (rounds of all tasks over two blocks per SM, times chunks), then the
    fewest rows loaded on the busiest SM (ceil(tasks / nsm) (R + CG)), then
    the largest R. Raises ValueError, naming the shape, where not even 8
    rows and one unit fit."""
    ngrp = math.ceil(ncols / MAX_CG)
    CG = _up(math.ceil(ncols / ngrp), 8)
    for budget in (SMEM_TWO, SMEM_BLOCK):
        best = None
        for R in range(MAX_R, 7, -8):
            NU = max((u for u in range(1, nprim + 1)
                      if fixed + max(8 * band_doubles(R, CG, u, nprim), other_bytes) <= budget),
                     default=0)
            if NU == 0:
                continue
            tasks = nslices * math.ceil(rows / R) * ngrp
            cost = (math.ceil((tasks + other_tasks) / (2 * nsm)) * math.ceil(nprim / NU),
                    math.ceil(tasks / nsm) * (R + CG), -R)
            if best is None or cost < best[0]:
                best = (cost, BandPlan(R, CG, NU, tasks))
        if best is not None:
            return best[1]
    need = fixed + 8 * band_doubles(8, CG, 1, nprim)
    raise ValueError(f"{name}: nprim={nprim} with {ncols} channels needs {need} bytes of shared "
                     f"memory for the smallest band tile, more than the card's {SMEM_BLOCK}")


class CrossPlan(NamedTuple):
    AG: int  # angular channels per cross task
    GG: int  # multipole channels per cross task
    tasks: int


def cross_plan(nprim: int, nang: int, NL: int, nelem: int, fixed: int) -> CrossPlan:
    """K1's cross-element tiles: the channels, then the g, of an element
    pair halved until a task holds at most four warp items per warp (an item
    is one channel and one g) and fits the shared memory of two blocks per
    SM, else of one. Raises ValueError, naming the shape, where one channel
    and one g of one pair do not fit."""
    for budget in (SMEM_TWO, SMEM_BLOCK):
        AG, GG = nang, NL
        while (AG * GG > 4 * WARPS
               or fixed + 8 * cross_doubles(AG, GG, nprim) > budget) and (AG > 1 or GG > 1):
            if AG > 1:
                AG = math.ceil(AG / 2)
            else:
                GG = math.ceil(GG / 2)
        if fixed + 8 * cross_doubles(AG, GG, nprim) <= budget:
            tasks = nelem * (nelem - 1) * math.ceil(nang / AG) * math.ceil(NL / GG)
            return CrossPlan(AG, GG, tasks)
    need = fixed + 8 * cross_doubles(1, 1, nprim)
    raise ValueError(f"radial_exchange: nprim={nprim} needs {need} bytes of shared memory for "
                     f"one element pair, more than the card's {SMEM_BLOCK}")


def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count
