"""The IEEE 33-bus radial feeder of Baran and Wu, with an MV/LV substation
of power electronics behind each load bus: writes this directory's
tables.

    python3 portbench/data/ieee33bw/make.py

M. E. Baran and F. F. Wu, "Network reconfiguration in distribution systems
for loss reduction and load balancing", IEEE Trans. Power Delivery
4(2):1401-1407, 1989 (MATPOWER's ``case33bw.m``): 12.66 kV, 33 buses, the
32 sectionalising branches below (the 5 tie lines open), 3,715 kW and
2,300 kvar of load.  On top of it, with the assumptions marked:

- bus 1 is the slack, with a shunt reactance of 1.6 ohm on the harmonic
  orders: 100 MVA of short-circuit power at 12.66 kV (assumed);
- bus b = 2..33 keeps 70% of its published load as a PQ load;
- node 100 + b is nonlinear, the other 30% of bus b's active power drawn
  by power electronics behind a 4% transformer loaded to 80%, X/R = 3
  (assumed), joined to bus b by that transformer's impedance in ohm on the
  12.66 kV side;
- its table ``smps_lv<b>_NE.csv`` aggregates N_b units of the upstream's
  SMPS Norton equivalent (``hpfx/data/smps_NE.csv``, at 400 V, read in
  place) behind an ideal 12.66 kV / 400 V ratio k: every current entry
  times N_b k, every admittance entry times N_b k^2, with
  N_b = 0.3 P_b / P_smps and P_smps the unit's fundamental draw at 400 V
  and no harmonic voltage.

The tables are in physical units (W, var, ohm; A and S in the Norton
tables), so the configuration's bases (10 MVA, 12.66 kV, 50 Hz) are
applied by whatever reads them.
"""
from __future__ import annotations

import csv
import math
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
SMPS_TABLE = os.path.join(ROOT, "hpfx", "data", "smps_NE.csv")

V_MV = 12660.0          # V, the feeder's nominal voltage
V_LV = 400.0            # V, the SMPS table's own base
X_SH_SLACK = 1.6        # ohm: 100 MVA of short-circuit power at 12.66 kV
PE_SHARE = 0.3          # of each bus's active load, behind its substation
Z_TRANSFORMER = 0.04    # per unit of the transformer's own rating
LOADING = 0.8           # the transformer's load over its rating
X_OVER_R = 3.0

#: from, to, R (ohm), X (ohm) of the 32 branches, as published
BRANCHES = """
1 2 .0922 .0470 | 2 3 .4930 .2511 | 3 4 .3660 .1864 | 4 5 .3811 .1941
5 6 .8190 .7070 | 6 7 .1872 .6188 | 7 8 .7114 .2351 | 8 9 1.0300 .7400
9 10 1.0440 .7400 | 10 11 .1966 .0650 | 11 12 .3744 .1238
12 13 1.4680 1.1550 | 13 14 .5416 .7129 | 14 15 .5910 .5260
15 16 .7463 .5450 | 16 17 1.2890 1.7210 | 17 18 .7320 .5740
2 19 .1640 .1565 | 19 20 1.5042 1.3554 | 20 21 .4095 .4784
21 22 .7089 .9373 | 3 23 .4512 .3083 | 23 24 .8980 .7091
24 25 .8960 .7011 | 6 26 .2030 .1034 | 26 27 .2842 .1447
27 28 1.0590 .9337 | 28 29 .8042 .7006 | 29 30 .5075 .2585
30 31 .9744 .9630 | 31 32 .3105 .3619 | 32 33 .3410 .5302
"""

#: bus: P (kW), Q (kvar), as published
LOADS = """
2 100 60 | 3 90 40 | 4 120 80 | 5 60 30 | 6 60 20 | 7 200 100 | 8 200 100
9 60 20 | 10 60 20 | 11 45 30 | 12 60 35 | 13 60 35 | 14 120 80
15 60 10 | 16 60 20 | 17 60 20 | 18 90 40 | 19 90 40 | 20 90 40
21 90 40 | 22 90 40 | 23 90 50 | 24 420 200 | 25 420 200 | 26 60 25
27 60 25 | 28 60 20 | 29 120 70 | 30 200 600 | 31 150 70 | 32 210 100
33 60 40
"""


def _entries(text: str):
    return [e.split() for line in text.strip().splitlines()
            for e in line.split("|")]


def branches():
    """[(from, to, R ohm, X ohm)] of the published feeder."""
    return [(int(f), int(t), float(r), float(x))
            for f, t, r, x in _entries(BRANCHES)]


def loads():
    """{bus: (P W, Q var)} of the published feeder."""
    return {int(b): (1e3 * float(p), 1e3 * float(q))
            for b, p, q in _entries(LOADS)}


def substation(bus: int) -> int:
    """The nonlinear node behind load bus ``bus``."""
    return 100 + bus


def transformer(P: float, Q: float):
    """(R, X) in ohm on the 12.66 kV side of the substation that serves a
    load of P W and Q var."""
    rating = math.hypot(P, Q) / LOADING
    z = Z_TRANSFORMER * V_MV ** 2 / rating
    return z / math.sqrt(1 + X_OVER_R ** 2), \
        z * X_OVER_R / math.sqrt(1 + X_OVER_R ** 2)


def _read_rows(path: str):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def _complex(s: str) -> complex:
    return complex(s.strip().strip("()"))


def smps_draw(rows) -> float:
    """The SMPS unit's fundamental draw (W) at V_LV and no harmonic
    voltage: Re(V conj(I_N[1] - Y_N[1, 1] V)) for V = V_LV."""
    freqs = rows[0][2:]
    col = freqs.index("50")
    I1 = next(_complex(r[2 + col]) for r in rows[1:] if r[0] == "I_N_c")
    Y11 = next(_complex(r[2 + col]) for r in rows[1:]
               if r[0] == "Y_N_c" and int(float(r[1])) == 50)
    return (V_LV * (I1 - Y11 * V_LV)).real


def aggregate(rows, units: float):
    """The rows of ``units`` SMPS units seen from the 12.66 kV side: the
    current rows (``I_N_c``, ``I_N_uc``) times units·k, the admittance
    rows (``Y_N_c``, ``Y_N_uc``) times units·k², k = V_LV / V_MV."""
    k = V_LV / V_MV
    out = [rows[0]]
    for r in rows[1:]:
        f = units * (k if r[0].startswith("I_") else k * k)
        out.append(r[:2] + [str(_complex(v) * f) for v in r[2:]])
    return out


def tables(split: bool = True):
    """(buses rows, lines rows) with their headers.  ``split`` False gives
    the published feeder alone: every load a PQ load, no substation."""
    ld = loads()
    share = 1.0 - PE_SHARE if split else 1.0
    buses = [["ID", "type", "component", "S", "P", "Q", "X_sh"],
             [1, "slack", "grid", 0, 0, 0, X_SH_SLACK]]
    buses += [[b, "PQ", f"load_{b}", 0, share * P, share * Q, 0]
              for b, (P, Q) in ld.items()]
    lines = [["ID", "fromID", "toID", "R", "X"]]
    lines += [[i + 1, f, t, r, x] for i, (f, t, r, x) in
              enumerate(branches())]
    if split:
        buses += [[substation(b), "nonlinear", f"smps_lv{b}", 0, 0, 0, 0]
                  for b in ld]
        lines += [[len(lines) + i, b, substation(b), *transformer(P, Q)]
                  for i, (b, (P, Q)) in enumerate(ld.items())]
    return buses, lines


def write_table(path: str, rows, delimiter: str) -> None:
    with open(path, "w", newline="") as fh:
        csv.writer(fh, delimiter=delimiter, lineterminator="\n").writerows(
            [[repr(v) if isinstance(v, float) else v for v in r]
             for r in rows])


def write(out_dir: str = HERE, smps_table: str = SMPS_TABLE) -> list:
    """Write ``buses.csv``, ``lines.csv`` and the 32 Norton tables into
    ``out_dir``; the names written."""
    rows = _read_rows(smps_table)
    p_unit = smps_draw(rows)
    buses, lines = tables()
    names = ["buses.csv", "lines.csv"]
    write_table(os.path.join(out_dir, names[0]), buses, ";")
    write_table(os.path.join(out_dir, names[1]), lines, ";")
    for b, (P, _) in loads().items():
        name = f"smps_lv{b}_NE.csv"
        write_table(os.path.join(out_dir, name),
               aggregate(rows, PE_SHARE * P / p_unit), ",")
        names.append(name)
    return names


if __name__ == "__main__":
    print(f"wrote {len(write())} files to {HERE}")
