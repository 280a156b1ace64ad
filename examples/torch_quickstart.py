"""Quickstart on the PyTorch port: the paper's algorithms on a
social-network-like graph through the port's ``AmpcEngine`` (Table 3 in
miniature), on the card by default.

One engine serves every problem; each ``solve`` returns an ``AmpcResult``
whose ``ledger`` carries the AMPC-vs-MPC round and byte accounting.

  PYTHONPATH=src python examples/torch_quickstart.py            # card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --tiny

``--tiny`` shrinks every graph (RMAT 2^9 instead of 2^12, cycles of 2,000
and 1,000 vertices, components of 300/200/100) for a quick CPU run.
"""
import argparse

import numpy as np

from repro_torch.ampc import AmpcEngine
from repro_torch.core import oracle
from repro_torch.graph import generators as gen

# (rmat log2 n, one cycle's n, two cycles' k, component sizes)
SIZES = {False: (12, 20000, 10000, [3000, 2000, 1000]),
         True: (9, 2000, 1000, [300, 200, 100])}


def run(device=None, tiny: bool = False) -> dict:
    """Every solve of the quickstart; returns what it prints, by name."""
    log2, n_one, k_two, parts_sizes = SIZES[tiny]
    g = gen.rmat(log2, 8.0, seed=0)
    print(f"graph: n={g.n} m={g.m} (RMAT, power-law)")
    eng = AmpcEngine(dht_backend="local", epsilon=0.5, seed=0, device=device)
    out = {"n": g.n, "m": g.m}

    # --- MIS
    ra = eng.solve(g, "mis")
    rm = eng.solve(g, "mis-mpc")
    assert np.array_equal(ra.output, rm.output), "same randomness => same MIS"
    out["mis"] = (int(ra.output.sum()), ra.shuffles,
                  float(ra.stats["cache_savings_factor"]), rm.shuffles)
    print(f"\nMIS: |I|={out['mis'][0]}  AMPC shuffles={ra.shuffles} "
          f"(cache saved {out['mis'][2]:.1f}x queries)  "
          f"MPC shuffles={rm.shuffles}")

    # --- Maximal matching
    rmm = eng.solve(g, "matching")
    out["matching"] = (int(rmm.output.sum()), rmm.shuffles,
                       bool(oracle.is_maximal_matching(g, rmm.output)))
    print(f"MM : |M|={out['matching'][0]}  AMPC shuffles={rmm.shuffles}  "
          f"maximal={out['matching'][2]}")

    # --- MSF (degree weights, Section 5.2)
    gw = g.with_degree_weights()
    rf = eng.solve(gw, "msf", skip_ternarize_if_dense=False)
    rfm = eng.solve(gw, "msf-mpc")
    out["msf"] = (float(gw.weights[rf.output].sum()), rf.shuffles,
                  float(rf.stats["avg_queries_per_vertex"]), rfm.shuffles,
                  int(rfm.stats["phases"]))
    print(f"MSF: weight={out['msf'][0]:.0f}  AMPC shuffles={rf.shuffles} "
          f"(queries/vertex={out['msf'][2]:.1f})  MPC shuffles="
          f"{rfm.shuffles} ({out['msf'][4]} Borůvka phases)")

    # --- 1-vs-2 cycle
    for name, cyc, expect in [("one", gen.one_cycle(n_one), 1),
                              ("two", gen.two_cycles(k_two), 2)]:
        ra = eng.solve(cyc, "one-vs-two", p=1 / 64)
        rm = eng.solve(cyc, "one-vs-two-mpc")
        out[f"1v2c_{name}"] = (ra.output, ra.shuffles, rm.output,
                               3 * int(rm.stats["phases"]))
        print(f"1v2c({name}): AMPC says {ra.output} in {ra.shuffles} "
              f"shuffles; MPC says {rm.output} in "
              f"{out[f'1v2c_{name}'][3]} shuffles")
        assert ra.output == rm.output == expect

    # --- connectivity
    parts = gen.disjoint_components(parts_sizes, 4.0, seed=1)
    rc = eng.solve(parts, "connectivity")
    out["cc"] = int(rc.stats["num_components"])
    print(f"CC : {out['cc']} components (expected {len(parts_sizes)})")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    return run(args.device, args.tiny)


if __name__ == "__main__":
    main()
