"""Environment report, the port's ``ds_report`` (``deepspeed_tpu/env_report.py``).

    python -m deepspeed_tpu_torch.env_report [--json]

Prints the Python, torch, CUDA and ``nvcc`` versions, each card's name
and power limit (``nvidia-smi``), and each CUDA library of
``ops/op_builder.SOURCES``: whether it is built in the build directory,
its digest (the name ``op_builder`` gives the library) and the arch it is
built for.  Without a card it says so and reports the rest.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Any, Dict, List


def _run(cmd: List[str]) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def _nvcc_version() -> str:
    from .ops import op_builder

    try:
        nvcc = op_builder._nvcc()
    except op_builder.KernelBuildError:
        return "not found"
    lines = _run([nvcc, "--version"]).splitlines()
    rel = [ln for ln in lines if "release" in ln]
    return rel[-1].strip() if rel else "unknown"


def _gpus() -> List[Dict[str, str]]:
    text = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    out = []
    for line in text.splitlines():
        name, _, power = line.partition(",")
        out.append({"name": name.strip(), "power_limit": power.strip()})
    return out


def report() -> Dict[str, Any]:
    import torch

    from .ops import op_builder

    arch = next(f.split("code=")[1] for f in op_builder.NVCC_FLAGS if "code=" in f)
    libs = {}
    for name in op_builder.SOURCES:
        path = op_builder._lib_path(name)
        libs[name] = {"built": path.exists(), "digest": path.stem.rsplit("_", 1)[1],
                      "arch": arch, "path": str(path)}
    cuda = torch.cuda.is_available()
    rep: Dict[str, Any] = {
        "python": sys.version.split()[0], "torch": torch.__version__,
        "torch_cuda": torch.version.cuda, "nvcc": _nvcc_version(),
        "cuda_available": cuda, "device_count": torch.cuda.device_count() if cuda else 0,
        "gpus": _gpus(), "build_dir": str(op_builder.build_dir()), "kernels": libs}
    if cuda:
        rep["torch_device_names"] = [torch.cuda.get_device_name(i)
                                     for i in range(torch.cuda.device_count())]
    return rep


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser("dstpu-torch-report", description=__doc__)
    ap.add_argument("--json", action="store_true", help="print one JSON object")
    args = ap.parse_args(argv)
    rep = report()
    if args.json:
        print(json.dumps(rep))
        return 0
    print("-" * 60)
    print("deepspeed_tpu_torch environment report")
    print("-" * 60)
    for key in ("python", "torch", "torch_cuda", "nvcc"):
        print(f"{key} {'.' * (22 - len(key))} {rep[key]}")
    if not rep["cuda_available"]:
        print("cuda .................. no CUDA device: the port runs only with "
              "device='cpu' here")
    for i, g in enumerate(rep["gpus"]):
        print(f"gpu {i} ................. {g['name']} ({g['power_limit']})")
    print(f"build dir ............. {rep['build_dir']}")
    print("kernels:")
    for name, k in rep["kernels"].items():
        print(f"  {name:<22} {'built' if k['built'] else 'not built':<10} "
              f"{k['digest']} {k['arch']}")
    print("-" * 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
