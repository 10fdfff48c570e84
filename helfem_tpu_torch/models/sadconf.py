"""Ground-state configuration machinery for the spherically-averaged atom,
carried over unchanged from helfem_tpu/models/sadconf.py (numpy only; the
port keeps its own copy).

Three pieces, mirroring the reference:

* `get_configuration(Z)` — the Saito (ADNDT 2009) ground-state occupation
  table for Z = 1..118, as electrons per l channel (s, p, d, f)
  (reference: src/sadatom/configurations.cpp:24-215).
* occupation helpers — `initial_occs` (Madelung guess), `hund_rule`
  (maximum-multiplicity alpha/beta split), `move_electrons` (all
  configurations reachable by moving 1..capacity electrons between two
  channels) (reference: src/sadatom/main.cpp:27-95,
  src/sadatom/solver.cpp:530-605).
* exhaustive ground-configuration searches — aufbau self-consistency plus
  brute-force MoveElectrons neighbor search with energy-ordered
  configuration lists, for the restricted (restr=1), unrestricted aufbau
  (restr=-1) and multiplicity-scan (restr=0) modes
  (reference: src/sadatom/main.cpp:280-560).

The searches are written against an abstract `solve(occs) -> (E, converged,
orbital_energies)` callback so they stay independent of the SCF backend;
`models/sadatom.py:solve_sadatom` provides it for the restricted search.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = [
    "get_configuration",
    "initial_occs",
    "hund_rule",
    "move_electrons",
    "aufbau_from_energies",
    "search_restricted",
    "search_unrestricted",
    "search_spin_scan",
]

# Saito 2009 ground-state configurations, electrons per l channel, written
# as [noble-core Z +] valence string. Published data (Table 2 of Saito,
# At. Data Nucl. Data Tables 95 (2009) 836; same table the reference embeds).
_CONFS = {
    1: "1s", 2: "2s",
    3: "2+1s", 4: "2+2s", 5: "2+2s1p", 6: "2+2s2p", 7: "2+2s3p",
    8: "2+2s4p", 9: "2+2s5p", 10: "2+2s6p",
    11: "10+1s", 12: "10+2s", 13: "10+2s1p", 14: "10+2s2p", 15: "10+2s3p",
    16: "10+2s4p", 17: "10+2s5p", 18: "10+2s6p",
    19: "18+1s", 20: "18+2s", 21: "18+2s1d", 22: "18+2s2d", 23: "18+2s3d",
    24: "18+1s5d", 25: "18+2s5d", 26: "18+2s6d", 27: "18+2s7d",
    28: "18+2s8d", 29: "18+1s10d", 30: "18+2s10d", 31: "18+2s10d1p",
    32: "18+2s10d2p", 33: "18+2s10d3p", 34: "18+2s10d4p", 35: "18+2s10d5p",
    36: "18+2s10d6p",
    37: "36+1s", 38: "36+2s", 39: "36+2s1d", 40: "36+2s2d", 41: "36+1s4d",
    42: "36+1s5d", 43: "36+2s5d", 44: "36+1s7d", 45: "36+1s8d", 46: "36+10d",
    47: "36+1s10d", 48: "36+2s10d", 49: "36+2s10d1p", 50: "36+2s10d2p",
    51: "36+2s10d3p", 52: "36+2s10d4p", 53: "36+2s10d5p", 54: "36+2s10d6p",
    55: "54+1s", 56: "54+2s", 57: "54+2s1d", 58: "54+2s1f1d", 59: "54+2s3f",
    60: "54+2s4f", 61: "54+2s5f", 62: "54+2s6f", 63: "54+2s7f",
    64: "54+2s7f1d", 65: "54+2s9f", 66: "54+2s10f", 67: "54+2s11f",
    68: "54+2s12f", 69: "54+2s13f", 70: "54+2s14f", 71: "54+2s14f1d",
    72: "54+2s14f2d", 73: "54+2s14f3d", 74: "54+2s14f4d", 75: "54+2s14f5d",
    76: "54+2s14f6d", 77: "54+2s14f7d", 78: "54+1s14f9d", 79: "54+1s14f10d",
    80: "54+2s14f10d", 81: "54+2s14f10d1p", 82: "54+2s14f10d2p",
    83: "54+2s14f10d3p", 84: "54+2s14f10d4p", 85: "54+2s14f10d5p",
    86: "54+2s14f10d6p",
    87: "86+1s", 88: "86+2s", 89: "86+2s1d", 90: "86+2s2d", 91: "86+2s2f1d",
    92: "86+2s3f1d", 93: "86+2s4f1d", 94: "86+2s6f", 95: "86+2s7f",
    96: "86+2s7f1d", 97: "86+2s8f1d", 98: "86+2s10f", 99: "86+2s11f",
    100: "86+2s12f", 101: "86+2s13f", 102: "86+2s14f", 103: "86+2s14f1d",
    104: "86+2s14f2d", 105: "86+2s14f3d", 106: "86+2s14f4d",
    107: "86+2s14f5d", 108: "86+2s14f6d", 109: "86+2s14f7d",
    110: "86+1s14f9d", 111: "86+1s14f10d", 112: "86+2s14f10d",
    113: "86+2s14f10d1p", 114: "86+2s14f10d2p", 115: "86+2s14f10d3p",
    116: "86+2s14f10d4p", 117: "86+2s14f10d5p", 118: "86+2s14f10d6p",
}

_LCHAN = {"s": 0, "p": 1, "d": 2, "f": 3}


def get_configuration(Z: int) -> np.ndarray:
    """Electrons per l channel (s, p, d, f) for the Saito ground state of
    element Z (1..118)."""
    if Z not in _CONFS:
        raise ValueError(f"unsupported element Z={Z}")
    cfg = _CONFS[Z]
    out = np.zeros(4, dtype=int)
    if "+" in cfg:
        corez, cfg = cfg.split("+")
        out += get_configuration(int(corez))
    for num, let in re.findall(r"(\d+)([spdf])", cfg):
        out[_LCHAN[let]] += int(num)
    if out.sum() != Z:
        raise AssertionError(f"configuration table error for Z={Z}")
    return out


def shell_capacity(l: int, restricted: bool) -> int:
    return (4 * l + 2) if restricted else (2 * l + 1)


def initial_occs(Z: int, lmax: int) -> np.ndarray:
    """Madelung-order guess occupation (reference: main.cpp initial_occs)."""
    shell_order = [0, 0, 1, 0, 1, 0, 2, 1, 0, 2, 1, 0, 3, 2, 1, 0, 3, 2, 1]
    occs = np.zeros(lmax + 1, dtype=int)
    left = Z
    for l in shell_order:
        if left == 0:
            break
        if l > lmax:
            raise ValueError(f"insufficient lmax={lmax} for Z={Z}")
        n = min(left, 2 * (2 * l + 1))
        occs[l] += n
        left -= n
    return occs


def hund_rule(occs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split total per-channel occupations into (alpha, beta) filling each
    shell with maximum multiplicity (reference: main.cpp hund_rule)."""
    occs = np.asarray(occs, dtype=int)
    occa = np.zeros_like(occs)
    occb = np.zeros_like(occs)
    for l in range(len(occs)):
        left = int(occs[l])
        while left > 0:
            nsh = min(left, 2 * (2 * l + 1))
            na = min(nsh, 2 * l + 1)
            occa[l] += na
            occb[l] += nsh - na
            left -= nsh
    return occa, occb


def move_electrons(occs: np.ndarray, restricted: bool) -> list[np.ndarray]:
    """All configurations reachable by moving 1..min(cap) electrons between
    two l channels, including the identity (reference:
    OrbitalChannel::MoveElectrons, solver.cpp:563-605)."""
    occs = np.asarray(occs, dtype=int)
    lmax = len(occs) - 1
    out = []
    for lf in range(lmax + 1):
        for lt in range(lmax + 1):
            cap = min(shell_capacity(lf, restricted), shell_capacity(lt, restricted))
            for nmove in range(1, cap + 1):
                if occs[lf] < nmove:
                    continue
                new = occs.copy()
                new[lf] -= nmove
                new[lt] += nmove
                out.append(new)
    if not out:
        out.append(np.zeros_like(occs))
    return out


def aufbau_from_energies(E: np.ndarray, nel: int, restricted: bool) -> np.ndarray:
    """Aufbau occupations from channel orbital energies E[nl, nmo]
    (reference: OrbitalChannel::AufbauOccupations, solver.cpp:530-561)."""
    nl, nmo = E.shape
    order = sorted((float(E[l, io]), l) for l in range(nl) for io in range(nmo))
    occs = np.zeros(nl, dtype=int)
    left = int(nel)
    for _, l in order:
        if left == 0:
            break
        n = min(shell_capacity(l, restricted), left)
        occs[l] += n
        left -= n
    return occs


class _Cache:
    """Memoized solve() keyed by the occupation tuple(s)."""

    def __init__(self, solve):
        self.solve = solve
        self.results = {}

    def __call__(self, key):
        if key not in self.results:
            self.results[key] = self.solve(key)
        return self.results[key]


def search_restricted(solve, occs0: np.ndarray, nel: int, verbose: bool = False):
    """Brute-force restricted ground-configuration search
    (reference: src/sadatom/main.cpp:300-350).

    solve(occs_tuple) -> (E, converged, orbE[nl, nmo]). Returns the
    energy-ordered configuration list [(occs_tuple, E, converged)].
    """
    cached = _Cache(solve)
    rlist = [tuple(int(x) for x in occs0)]
    cached(rlist[0])

    while True:
        rlist.sort(key=lambda k: cached(k)[0])
        # aufbau self-consistency from the current best configuration
        conf = tuple(aufbau_from_energies(cached(rlist[0])[2], nel, True))
        while conf not in rlist:
            cached(conf)
            rlist.append(conf)
            conf = tuple(aufbau_from_energies(cached(conf)[2], nel, True))
        if verbose:
            print("Aufbau search finished")
        rlist.sort(key=lambda k: cached(k)[0])
        # exhaustive neighbor moves from the best configuration
        newconf = False
        for trial in move_electrons(np.array(rlist[0]), True):
            t = tuple(int(x) for x in trial)
            if t not in rlist:
                newconf = True
                cached(t)
                rlist.append(t)
        if verbose:
            print("Exhaustive search finished")
        if not newconf:
            break

    rlist.sort(key=lambda k: cached(k)[0])
    return [(k, cached(k)[0], cached(k)[1]) for k in rlist]


def search_unrestricted(solve, occa0: np.ndarray, occb0: np.ndarray, nel: int,
                        verbose: bool = False):
    """Unrestricted aufbau search (reference restr=-1 path,
    src/sadatom/main.cpp:367-460): the spin split always follows Hund's rule
    on the restricted helper configuration.

    solve((occa_tuple, occb_tuple)) -> (E, converged, orbE_a[nl, nmo]).
    Returns the energy-ordered list [((occa, occb), E, converged)].
    """
    cached = _Cache(solve)

    def hund_key(occs_total):
        a, b = hund_rule(occs_total)
        return (tuple(int(x) for x in a), tuple(int(x) for x in b))

    ulist = [(tuple(int(x) for x in occa0), tuple(int(x) for x in occb0))]
    cached(ulist[0])

    while True:
        ulist.sort(key=lambda k: cached(k)[0])
        # restricted helper = occa + occb of the best config; aufbau with the
        # alpha orbital energies and restricted capacities, then Hund split
        best = ulist[0]
        helper = aufbau_from_energies(cached(best)[2], nel, True)
        conf = hund_key(helper)
        while conf not in ulist:
            cached(conf)
            ulist.append(conf)
            helper = aufbau_from_energies(cached(conf)[2], nel, True)
            conf = hund_key(helper)
        if verbose:
            print("Aufbau search finished")
        ulist.sort(key=lambda k: cached(k)[0])
        helper_best = np.array(ulist[0][0]) + np.array(ulist[0][1])
        newconf = False
        for trial in move_electrons(helper_best, True):
            t = hund_key(trial)
            if t not in ulist:
                newconf = True
                cached(t)
                ulist.append(t)
        if verbose:
            print("Exhaustive search finished")
        if not newconf:
            break

    ulist.sort(key=lambda k: cached(k)[0])
    return [(k, cached(k)[0], cached(k)[1]) for k in ulist]


def search_spin_scan(solve, nel: int, lmax: int, max_dx: int = 5,
                     verbose: bool = False):
    """Multiplicity scan (reference restr=0 path, main.cpp:460-560): for each
    spin split (nelb = nel//2 - dx), run independent per-spin aufbau + the
    product of per-spin MoveElectrons neighbors; collect everything into one
    energy-ordered list.

    solve((occa, occb)) -> (E, converged, orbE_a, orbE_b).
    """
    cached = _Cache(solve)
    totlist = []
    for dx in range(max_dx + 1):
        nelb = nel // 2 - dx
        nela = nel - nelb
        if nelb < 0:
            break
        if verbose:
            print(f" ************ M = {nela - nelb + 1} ************")
        occa = initial_occs(nela, lmax) if nela else np.zeros(lmax + 1, dtype=int)
        occb = initial_occs(nelb, lmax) if nelb else np.zeros(lmax + 1, dtype=int)
        ulist = [(tuple(int(x) for x in occa), tuple(int(x) for x in occb))]
        cached(ulist[0])
        while True:
            ulist.sort(key=lambda k: cached(k)[0])
            conf = ulist[0]
            Ea, Eb = cached(conf)[2], cached(conf)[3]
            conf = (
                tuple(aufbau_from_energies(Ea, nela, False)),
                tuple(aufbau_from_energies(Eb, nelb, False)),
            )
            while conf not in ulist:
                cached(conf)
                ulist.append(conf)
                Ea, Eb = cached(conf)[2], cached(conf)[3]
                conf = (
                    tuple(aufbau_from_energies(Ea, nela, False)),
                    tuple(aufbau_from_energies(Eb, nelb, False)),
                )
            ulist.sort(key=lambda k: cached(k)[0])
            movesa = move_electrons(np.array(ulist[0][0]), False)
            movesb = move_electrons(np.array(ulist[0][1]), False)
            newconf = False
            for ta in movesa:
                for tb in movesb:
                    t = (tuple(int(x) for x in ta), tuple(int(x) for x in tb))
                    if t not in ulist:
                        newconf = True
                        cached(t)
                        ulist.append(t)
            if not newconf:
                break
        totlist.extend(ulist)

    totlist = list(dict.fromkeys(totlist))
    totlist.sort(key=lambda k: cached(k)[0])
    return [(k, cached(k)[0], cached(k)[1]) for k in totlist]
