"""Single-linkage hierarchical clustering via MSF on the PyTorch port (the
paper's flagship application, Section 1), on the card by default.

Builds a noisy point cloud with 4 planted clusters, computes the MSF of
the k-nearest-neighbour graph in constant adaptive rounds, cuts the
heaviest edges, and recovers the clusters with forest connectivity, both
solves through one ``AmpcEngine``.

  PYTHONPATH=src python examples/torch_graph_analytics.py
  PYTHONPATH=src python examples/torch_graph_analytics.py --device cpu --tiny

``--tiny`` plants 50 points a cluster instead of 150.
"""
import argparse

import numpy as np

from repro_torch.ampc import AmpcEngine
from repro_torch.graph.coo import UGraph


def make_clusters(k=4, per=150, spread=0.06, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.random((k, 2)) * 4.0
    pts = np.concatenate([c + rng.standard_normal((per, 2)) * spread
                          for c in centers])
    truth = np.repeat(np.arange(k), per)
    return pts.astype(np.float32), truth


def knn_graph(pts, k=8):
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, axis=1)[:, :k]
    rows = np.repeat(np.arange(len(pts)), k)
    cols = nbr.ravel()
    w = np.sqrt(d2[rows, cols]).astype(np.float32)
    g = UGraph(len(pts), np.stack([rows, cols], 1).astype(np.int32), w)
    return g.dedup()


def run(device=None, tiny: bool = False) -> dict:
    pts, truth = make_clusters(per=50 if tiny else 150)
    g = knn_graph(pts)
    print(f"kNN graph: n={g.n} m={g.m}")
    eng = AmpcEngine(seed=0, device=device)

    # 1) MSF in constant adaptive rounds
    res = eng.solve(g, "msf", skip_ternarize_if_dense=False)
    mask = res.output
    print(f"MSF edges: {mask.sum()} (queries/vertex "
          f"{res.stats['avg_queries_per_vertex']:.1f}, "
          f"{res.shuffles} shuffles)")

    # 2) "simple sorting step": cut the 3 heaviest MSF edges
    fe = np.where(mask)[0]
    order = fe[np.argsort(-g.weights[fe])]
    keep = np.ones(g.m, bool)
    keep[order[:3]] = False           # cut 3 heaviest => 4 clusters
    cut = mask & keep

    # 3) forest connectivity on the remaining forest
    forest = UGraph(g.n, g.edges[cut])
    labels = eng.solve(forest, "connectivity").output

    # score: purity of recovered clusters vs planted truth
    uniq = np.unique(labels)
    purity = sum(np.bincount(truth[labels == u]).max() for u in uniq
                 if (labels == u).any()) / len(truth)
    print(f"clusters found: {len(uniq)} (planted 4); purity={purity:.3f}")
    assert purity > 0.95, "single-linkage clustering should recover clusters"
    print("OK")
    return {"msf_edges": int(mask.sum()), "clusters": len(uniq),
            "purity": float(purity), "labels": labels}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    return run(args.device, args.tiny)


if __name__ == "__main__":
    main()
