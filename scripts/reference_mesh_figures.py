"""The JAX reference's per-device figures of LM train and prefill cells at
16x16, read on the CPU: its ``build_lowerable`` compiled on a 16x16
``jax.sharding.Mesh`` of 256 host devices (Auto axes; the reference's own
``python -m repro.launch.dryrun`` raises on these cells), then

  * ``peak``: ``memory_analysis()``'s argument + temp bytes, plus output
    bytes for prefill (whose KV cache is an output);
  * ``flops`` and ``wire``: ``repro.launch.hlo.analyze_hlo``'s FLOPs and
    collective wire bytes a device.

    PYTHONPATH=src python scripts/reference_mesh_figures.py \\
        llama4-scout-17b-a16e/prefill_32k mixtral-8x22b/prefill_32k

One JSON line a cell on standard output.  These are the figures
``tests/test_torch_dryrun_mesh.py::TRAIN_PREFILL_REFERENCE`` holds the
port's sharded records to.  Compile-time counts, no device time.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.launch.hlo import analyze_hlo  # noqa: E402
from repro.launch.specs import build_lowerable  # noqa: E402


def figures(arch: str, shape: str) -> dict:
    mesh = Mesh(np.array(jax.devices()[:256]).reshape(16, 16),
                ("data", "model"))
    t0 = time.perf_counter()
    low = build_lowerable(arch, shape, mesh)
    compiled = low.lower(mesh).compile()
    mem = compiled.memory_analysis()
    peak = mem.argument_size_in_bytes + mem.temp_size_in_bytes
    if shape.startswith("prefill"):
        peak += mem.output_size_in_bytes
    a = analyze_hlo(compiled.as_text())
    return {"cell": f"{arch}/{shape}", "mesh": "16x16", "peak": peak,
            "flops": a.flops, "wire": a.collectives.wire_bytes,
            "argument": mem.argument_size_in_bytes,
            "temp": mem.temp_size_in_bytes,
            "output": mem.output_size_in_bytes,
            "seconds": time.perf_counter() - t0}


def main(cells) -> int:
    for cell in cells:
        arch, shape = cell.split("/")
        print(json.dumps(figures(arch, shape)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
