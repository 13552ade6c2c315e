#!/usr/bin/env python3
"""The seconds that ``chip_smoke.py``'s host-side cut saves, in turns, on
one NVIDIA GPU.

    python3 smoke_cut_turns.py PARENT_DIR

``PARENT_DIR`` holds the parent commit's tree (``git archive <commit> |
tar -x -C PARENT_DIR``).  Four turns, parent, new, new, parent, each the
smoke's kernel phases (2-3, 6-7, 10-11, 15, 18-21) followed by phase 30
(the optimizers, card against CPU):

- parent: the parent's ``chip_smoke.py`` phases in its order, phase 30
  computing its CPU arithmetic inline;
- new: this tree's, as its ``main`` runs them: the CPU arithmetic on a
  ``BackgroundReference`` worker started before phase 2 and joined
  before phase 18, phase 30 then comparing with it.

One JSON line per turn (its seconds, the kernel phases' and phase 30's,
the worker's seconds, cores and wait, the model-level parity's steps per
optimizer), then a ``turns`` line with the card's name and power limit.
Both trees' phases run on this tree's package and kernels, built once.
Needs CUDA and ``nvcc``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv) -> int:
    if len(argv) != 1 or not os.path.isfile(os.path.join(argv[0], "chip_smoke.py")):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("smoke_cut_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as new
    from deepspeed_tpu_torch.ops import evoformer_attn as ev
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fadam
    from deepspeed_tpu_torch.ops import grouped_matmul as gm
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quantization as qz
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops import wq_matmul as wq

    parent = _load(os.path.join(argv[0], "chip_smoke.py"), "parent_chip_smoke")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    t = time.perf_counter()
    op_builder.build()
    print(json.dumps({"build_s": time.perf_counter() - t}), flush=True)
    new.BASE = parent.BASE = None  # no previous builds: both trees time the same kernels
    new.warm_clocks()

    def run(cs, names_args):
        for name, arg in names_args:
            getattr(cs, name)(arg)

    first = (("flash_phase", fa), ("paged_phase", pa), ("flash_bwd_phase", fa),
             ("adam_phase", fadam), ("wq_phase", wq), ("quant_phase", qz),
             ("gmm_phase", gm), ("gmm_bwd_phase", gm))
    profiled = (("sparse_phase", sa), ("evo_phase", ev), ("evo_train_phase", ev))
    turns = []
    for which in ("parent", "new", "new", "parent"):
        t0 = time.perf_counter()
        ref = None
        if which == "new":
            ref = new.BackgroundReference(new.optimizer_cpu_reference,
                                          max(1, (os.cpu_count() or 2) // 2 - 1))
            run(new, first)
            ref.join()
            run(new, profiled)
        else:
            run(parent, first + profiled)
        t1 = time.perf_counter()
        out = new.optimizers_phase(ref) if which == "new" else parent.optimizers_phase()
        t2 = time.perf_counter()
        turns.append({"turn": which, "total_s": t2 - t0, "kernel_phases_s": t1 - t0,
                      "optimizers_phase_s": t2 - t1,
                      "worker_s": ref.result["seconds"] if ref else None,
                      "worker_waited_s": ref.waited_s if ref else None,
                      "worker_cores": ref.cores if ref else None,
                      "parity_steps": {n: r["steps"] for n, r in out["training"].items()}})
        print(json.dumps({"turn": turns[-1]}), flush=True)
    mean = {w: sum(t["total_s"] for t in turns if t["turn"] == w) / 2 for w in ("parent", "new")}
    print(json.dumps({"turns": turns, "saved_s": mean["parent"] - mean["new"], "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
