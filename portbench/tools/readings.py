"""The readings the limits of `correct` are set from, on the card, at a
cell's own sizes, in one process:

* the port: for each seed, the numbers that a run of the cell compares
  (its maps of each of the cell's batches through the same
  `sample_saliency` call the window makes, or its checked training steps
  through the same step), against the reference;
* the control: for each control seed, the reference itself computed with
  every product's operands in float8 e4m3 (`reference.model.LOWP`, the
  precision below the configuration's bf16), in the port's place;
* a fault: for each fault seed, the port with one of `faults.FAULTS`
  planted in its timed path.

    python3 portbench/tools/readings.py --workload av_ddim_b30 \
        --seeds 1 2 3 --control-seeds 1 2 3 [--fault half_batch_infer \
        --fault-seeds 1 2 3] --out readings.json

Prints one JSON line per reading and writes them all to --out."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench.core import check, data, port, session, spec  # noqa: E402
from portbench.reference import model as ref_model  # noqa: E402
from portbench.tools import faults  # noqa: E402


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def port_maps(cfg, traffic, seed, batches):
    model = port.build_model(cfg["model"], data.draw_weights(cfg["model"], seed, session.DEVICE),
                             session.DEVICE, train=False)
    call = port.sampler(model, traffic["sampler"])
    maps = {i: call(b).cpu() for i, b in enumerate(batches)}
    del model, call
    _free()
    return maps


def port_steps(cfg, traffic, seed, batches):
    """The port's checked steps, as set-up drives them in a run."""
    weights = data.draw_weights(cfg["model"], seed, session.DEVICE)
    model = port.build_model(cfg["model"], weights, session.DEVICE, train=True)
    names = port.trainable_names(model)
    w0 = {n: weights[n].cpu() for n in names}
    del weights
    step, opt = port.trainer(model, cfg["model"], traffic["optim"])
    gen = torch.Generator(device=session.DEVICE).manual_seed(spec.subseed(seed, "steps"))
    out = session.checked_steps(model, step, opt, names, w0, batches, gen,
                                traffic["checked_steps"])
    del model, opt, step
    _free()
    return out


def reference_steps(cfg, traffic, seed, batches):
    losses, g1, change = check.reference_steps(cfg["model"], traffic, seed, session.DEVICE,
                                               batches)
    out = losses, {k: v.cpu() for k, v in g1.items()}, {k: v.cpu() for k, v in change.items()}
    _free()
    return out


def reading(cell, cfg, traffic, seed, control: bool, fault=None):
    if fault is not None:
        with faults.planted(fault):
            r = reading(cell, cfg, traffic, seed, control)
        return dict(r, side=fault)
    batches = data.draw_batches(cfg["model"], traffic, seed, session.DEVICE)
    t0 = time.perf_counter()
    if traffic["kind"] == "infer":
        refs = check.reference_maps(cfg["model"], traffic, seed, session.DEVICE, batches)
        if control:
            ref_model.LOWP["on"] = True
            try:
                got = dict(enumerate(check.reference_maps(cfg["model"], traffic, seed,
                                                          session.DEVICE, batches)))
            finally:
                ref_model.LOWP["on"] = False
        else:
            got = port_maps(cfg, traffic, seed, batches)
        numbers, notes = check.map_numbers(got, refs), {}
    else:
        ref = reference_steps(cfg, traffic, seed, batches)
        if control:
            ref_model.LOWP["on"] = True
            try:
                got = reference_steps(cfg, traffic, seed, batches)
            finally:
                ref_model.LOWP["on"] = False
        else:
            got = port_steps(cfg, traffic, seed, batches)
        numbers, notes = check.step_numbers(*got, *ref)
    del batches
    _free()
    return {"workload": cell["name"], "seed": seed, "side": "control" if control else "port",
            "numbers": numbers, "notes": notes, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=faults.FAULTS)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cell = spec.workload(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    port.build_kernels()
    out = []
    for control, fault, seeds in ((False, None, args.seeds), (True, None, args.control_seeds),
                                  (False, args.fault, args.fault_seeds)):
        for seed in seeds:
            r = reading(cell, cfg, traffic, seed, control, fault)
            print(json.dumps(r), flush=True)
            out.append(r)
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
