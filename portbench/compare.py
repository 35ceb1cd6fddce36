"""What decides ``correct``: the window's answers held against the plain
reference, and the accuracy gate that decides ``failed``.

After the window has closed, a sample of the answers it produced, drawn
from the seed, is made again from its unit's random stream and run
through the configuration's plain reference (``references/<name>.py``);
a batch cell samples ``sample.pairs`` pairs of its batches, the online
cell one lap's first ``sample.scans`` scans, which the reference follows
as a chain of its own warm starts.  Three numbers come out of it:

  * ``rot_gap_deg``: the largest angle between the program's and the
    reference's rotation, degrees;
  * ``tra_gap``: the largest distance between their translations, in the
    clouds' units;
  * ``iter_gap``: the largest difference of their iteration counts.

Each number that the cell's limits file names is compared with its
limit; the run is correct when every one is within it.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic import stream

ROT_GATE_DEG, TRA_GATE = 2.0, 0.25


def rot_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle of Ra^T Rb, degrees, from the chord |Ra - Rb|_F =
    2 sqrt(2) sin(angle / 2) (exact for small angles too)."""
    chord = np.linalg.norm(np.asarray(Ra) - np.asarray(Rb), axis=(-2, -1))
    return np.degrees(2 * np.arcsin(np.clip(chord / (2 * np.sqrt(2)), 0, 1)))


def gate(T: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """[P] bool: each transform within 2 degrees and 0.25 of its ground
    truth (the reference's success rule)."""
    rot = rot_deg(T[:, :3, :3], gts[:, :3, :3])
    tra = np.linalg.norm(T[:, :3, 3] - gts[:, :3, 3], axis=-1)
    return np.isfinite(T).all(axis=(1, 2)) & (rot <= ROT_GATE_DEG) & (
        tra <= TRA_GATE)


def sample(units, kind: str, traffic: dict, seed: int) -> list:
    """The answers to hold, drawn from the seed: [(unit, slot)] where
    the units are batches, one lap's first scans where they are laps."""
    rng = stream(seed, "sample")
    if kind == "lap":
        want = traffic["sample"]["scans"]
        laps = {}
        for u in units:
            laps.setdefault(u.lap, []).append(u)
        full = sorted(lap for lap, us in laps.items() if len(us) >= want)
        if not full:        # a window shorter than a lap's first scans
            full = [max(laps, key=lambda lap: len(laps[lap]))]
        lap = full[int(rng.integers(len(full)))]
        return [(u, 0) for u in sorted(laps[lap], key=lambda u: u.scan)
                ][:want]
    slots = [(u, i) for u in units for i in range(len(u.it))]
    take = rng.choice(len(slots), min(len(slots), traffic["sample"]["pairs"]),
                      replace=False)
    return [slots[i] for i in sorted(take)]


def reference_answers(picked, kind: str, scene, config: dict, ref, device,
                      precision: str = "float64") -> list:
    """The reference's (T, iterations) for each picked answer, from the
    same inputs, made again from their units' streams."""
    reg = config["registration"]
    out = []
    if kind == "lap":
        pairs, _ = scene.lap("lap", picked[0][0].lap)
        T_prev = None
        for u, _ in picked:
            T, it, _ = ref.register(*pairs[u.scan], reg, T0=T_prev,
                                    precision=precision, device=device)
            T_prev = T
            out.append((T, it))
        return out
    made = {}
    for u, i in picked:
        if u.index not in made:
            made[u.index] = scene.batch("batch", u.index, len(u.it))[0]
        T, it, _ = ref.register(*made[u.index][i], reg, precision=precision,
                                device=device)
        out.append((T, it))
    return out


def gaps(program: list, reference: list) -> dict:
    """The three numbers from [(T, it)] of the program and the
    reference, answer by answer."""
    Tp = np.stack([T for T, _ in program])
    Tr = np.stack([T for T, _ in reference])
    if not np.isfinite(Tp).all():
        return dict(rot_gap_deg=float("inf"), tra_gap=float("inf"),
                    iter_gap=float("inf"))
    return dict(
        rot_gap_deg=float(rot_deg(Tp[:, :3, :3], Tr[:, :3, :3]).max()),
        tra_gap=float(np.linalg.norm(Tp[:, :3, 3] - Tr[:, :3, 3],
                                     axis=-1).max()),
        iter_gap=float(max(abs(a - b) for (_, a), (_, b)
                           in zip(program, reference))))


def verdict(got: dict, limits: dict) -> tuple:
    """(correct, {number: (value, limit or None)}): correct when every
    number that has a limit is within it."""
    numbers = {k: (v, limits.get(k)) for k, v in got.items()}
    return all(v <= lim for v, lim in numbers.values()
               if lim is not None), numbers


def judge(units, kind: str, scene, traffic, config, ref, limits: dict,
          seed: int, device) -> tuple:
    """(correct, {number: (value, limit or None)}) of a window."""
    picked = sample(units, kind, traffic, seed)
    if not picked:
        return False, {}
    program = [(u.T[i], int(u.it[i])) for u, i in picked]
    return verdict(gaps(program, reference_answers(
        picked, kind, scene, config, ref, device)), limits)
