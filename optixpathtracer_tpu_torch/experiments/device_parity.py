"""Where a render on the card parts from the same render on the CPU, op by op.

    python -m optixpathtracer_tpu_torch.experiments.device_parity
        [--goldens whitted foveated ...] [--traversal cluster] [--out FILE]

For each named golden setup (`scenes.render_golden`) it renders once on
the card and once on the CPU and prints the sqrt-space RMSE between the two
(`golden_rmse`, the metric of the goldens). Then it renders the setup on the
card again under `ShadowMode`: every aten operation that takes a tensor on
the card also runs on CPU copies of its inputs, and the two results are
compared bit for bit. An operation whose outputs (or mutated inputs) differ
on identical inputs is a place where the card's arithmetic parts from the
CPU's. Those are grouped by operation and by the innermost line of this
package that called it, with the order of their first parting, the number
of calls and elements that parted, the largest absolute and relative
difference, and the first parting element of the first parting call: its
flat index (`first_lane`), the inputs of the same size there, and both
results. The CUDA kernels of `ops/` run outside the dispatcher and are
not shadowed (chip_smoke.py holds each bit for bit against its plain
version). One JSON object per setup goes to stdout and, with --out, to a
file. It fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETUPS = ("whitted", "foveated", "disney_open", "spectral", "spectral_s", "whitted_s",
          "disney_open_s", "foveated_s", "hello", "disney_cornell_s", "disney_cornell",
          "loft_s", "loft", "gltf")
_aten = torch.ops.aten
# operations whose outputs hold no defined values, or only alias their input
UNCHECKED = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.empty_like.default, _aten.resize_.default,
    _aten.set_.source_Storage_storage_offset, _aten.detach.default, _aten.alias.default,
    _aten.record_stream.default,
}


def _site() -> str:
    """The innermost frame in this package outside this file, as file:line (function)."""
    for fr in reversed(traceback.extract_stack()):
        if fr.filename.startswith(PKG) and not fr.filename.endswith("device_parity.py"):
            return f"{os.path.relpath(fr.filename, os.path.dirname(PKG))}:{fr.lineno} ({fr.name})"
    return "outside the package"


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, torch.device) and x.type != "cpu":
        return torch.device("cpu")
    return x


def _parted(a: torch.Tensor, b: torch.Tensor):
    """(elements apart, max abs diff, max rel diff, first index apart) of two
    tensors of one shape, NaN equal to NaN; None when equal."""
    a = a.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return (max(a.numel(), b.numel()), float("inf"), float("inf"), 0)
    if a.dtype.is_floating_point:
        apart = ~((a == b) | (torch.isnan(a) & torch.isnan(b)))
    else:
        apart = a != b
    n = int(apart.sum())
    if n == 0:
        return None
    fa, fb = a[apart].double(), b[apart].double()
    diff = (fa - fb).abs()
    rel = diff / torch.maximum(fa.abs(), fb.abs()).clamp_min(1e-30)
    first = int(torch.nonzero(apart.reshape(-1))[0])
    return n, float(diff.max()), float(rel.max()), first


class ShadowMode(TorchDispatchMode):
    """Runs every aten op on a non-CPU tensor a second time on CPU copies of
    its inputs and records where the results part (see the module doc)."""

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        self.device_type = device_type
        self.ops = 0
        self.sites: dict[str, dict] = {}
        self.cpu_failed: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, spec = pytree.tree_flatten((args, kwargs))
        if func in UNCHECKED or not any(
                isinstance(x, torch.Tensor) and x.device.type == self.device_type for x in flat):
            return func(*args, **kwargs)
        self.ops += 1
        cpu_flat = [_to_cpu(x) for x in flat]
        out = func(*args, **kwargs)
        cargs, ckwargs = pytree.tree_unflatten(cpu_flat, spec)
        try:
            cout = func(*cargs, **ckwargs)
        except Exception as e:  # noqa: BLE001 — an op the CPU lacks: count it, go on
            key = f"{func}: {type(e).__name__}"
            self.cpu_failed[key] = self.cpu_failed.get(key, 0) + 1
            return out
        pairs = [(a, b) for a, b in zip(pytree.tree_leaves(out), pytree.tree_leaves(cout))
                 if isinstance(a, torch.Tensor)]
        pairs += [(a, b) for a, b in zip(flat, cpu_flat)  # mutated inputs
                  if isinstance(a, torch.Tensor) and a.device.type == self.device_type]
        worst = None
        for a, b in pairs:
            p = _parted(a, b)
            if p is not None and (worst is None or p[0] > worst[0]):
                worst, parted = p, (a, b)
        if worst is not None:
            scalars = [x for x in flat if isinstance(x, (int, float, bool)) and not isinstance(x, torch.Tensor)]
            key = f"{func} @ {_site()}"
            rec = self.sites.get(key)
            if rec is None:
                shapes = [list(x.shape) for x in flat if isinstance(x, torch.Tensor)]
                i = worst[3]  # the first parting element of the first parting call
                card, cpu = parted
                ins = [float(x.reshape(-1)[i]) for x in cpu_flat
                       if isinstance(x, torch.Tensor) and x.numel() == card.numel()
                       and x.dtype.is_floating_point]
                rec = self.sites[key] = dict(first_op=self.ops, calls=0, elements=0, max_abs=0.0,
                                             max_rel=0.0, shapes=shapes, scalars=scalars[:4],
                                             first_lane=i, first_inputs=ins,
                                             first_card=float(card.reshape(-1)[i]),
                                             first_cpu=float(cpu.reshape(-1)[i]))
            rec["calls"] += 1
            rec["elements"] += worst[0]
            rec["max_abs"] = max(rec["max_abs"], worst[1])
            rec["max_rel"] = max(rec["max_rel"], worst[2])
        return out


def trace(name: str, device, traversal: str = "cluster", top: int = 25) -> dict:
    """The card-against-CPU gap of one golden setup and its parting ops."""
    from .. import scenes

    cpu = scenes.render_golden(name, torch.device("cpu"), traversal)
    card = scenes.render_golden(name, device, traversal)
    mode = ShadowMode(device.type)
    with mode:
        shadowed = scenes.render_golden(name, device, traversal)
    sites = sorted(mode.sites.items(), key=lambda kv: kv[1]["first_op"])
    return {
        "setup": name, "traversal": traversal,
        "rmse_card_vs_cpu": scenes.golden_rmse(card, cpu),
        "rmse_shadowed_vs_card": scenes.golden_rmse(shadowed, card),
        "ops_shadowed": mode.ops, "sites_parted": len(sites),
        "cpu_failed": mode.cpu_failed,
        "sites": [dict(site=k, **v) for k, v in sites[:top]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--goldens", nargs="*", default=list(SETUPS[:5]), choices=SETUPS)
    ap.add_argument("--traversal", default="cluster")
    ap.add_argument("--top", type=int, default=25, help="parting sites listed per setup")
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("device_parity: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    recs = []
    for name in args.goldens:
        rec = trace(name, dev, args.traversal, args.top)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in recs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
