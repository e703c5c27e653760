"""Import a released reference checkpoint into a port checkpoint directory
(JAX package `scripts/import_reference_ckpt.py`).

    python -m diff_sal_tpu_torch.scripts.import_reference_ckpt <ckpt> <out_dir> \\
        [--kind full|mvit|vggish]

kind=full: a DiffSal best.pth (a `module.`-prefixed VideoSaliencyModel);
kind=mvit: a Kinetics MViT checkpoint (`backbone.`-prefixed, or bare);
kind=vggish: vggish.pth. The entries (`train/convert.py`) go to
`<out_dir>/0.pth` as the reference's {"state_dict", "optim_dict": None,
"epoch": 0, "step": 0}, with a `best.json` that points at it, so the
port's readers find it: the CLI's `--pretrain_path <out_dir>` (the warm
start of `train-visual` / `train-av`, every kind) and, for a full model,
`test` / `test-av` with `<out_dir>` as `<workdir>/weights` or
`<workdir>/<split>/weights`. Prints the count of loaded tensors and what
was dropped, by reason.
"""

from __future__ import annotations

import argparse
import time

from diff_sal_tpu_torch.train import convert
from diff_sal_tpu_torch.train.checkpoint import CheckpointManager


def import_checkpoint(ckpt: str, out_dir: str, kind: str = "full", num_mvit_layers: int = 16
                      ) -> convert.Report:
    """Convert `ckpt` into `out_dir` and print the report; every released
    MViT is MViTv2-S (16 blocks), the default, as in JAX's script."""
    t0 = time.perf_counter()
    sd = convert.load_torch_state_dict(ckpt)
    state_dict, report = convert.convert_checkpoint(sd, kind, num_mvit_layers)
    mgr = CheckpointManager(out_dir)
    if mgr.all_steps() or mgr.best() is not None:
        raise FileExistsError(f"{out_dir} already holds checkpoints")
    mgr.save(0, {"state_dict": state_dict, "optim_dict": None, "epoch": 0, "step": 0})
    # imported weights carry no validation score: any trained epoch beats it
    mgr.update_best(0, float("-inf"))
    for line in report.lines():
        print(line)
    print(f"converted {report.loaded} tensors ({kind}) -> {out_dir} in "
          f"{time.perf_counter() - t0:.1f} s")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("out_dir")
    ap.add_argument("--kind", default="full", choices=list(convert.KINDS))
    args = ap.parse_args(argv)
    return import_checkpoint(args.ckpt, args.out_dir, args.kind)


if __name__ == "__main__":
    main()
