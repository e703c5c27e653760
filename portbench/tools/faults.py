"""Faults planted in the port's timed path, underneath the harness, for
the readings that set the limits of `correct` and for the tests that see
a broken path come out not correct. Each is a context manager.

* `answer_altered` (inference): the first map of each batch raised by
  0.25 over its top quarter, where the sampler returns it.
* `half_batch_infer`: the sampler runs the first half of the batch, and
  the rest of the maps are the mean of those.
* `state_unchanged_infer`: the sampler (DDIM or DPM-Solver) returns x_T
  as it got it.
* `state_unchanged_train`: the optimizer's step leaves every parameter
  and its state as they were.
* `half_batch_train`: the loss is the mean over the first half of the
  batch alone.
* `answer_altered_train`: the model's output for the batch's first row
  raised by 0.5 where the loss reads it.

There is one card, so no exchange between cards can be left out."""

from __future__ import annotations

import contextlib

import torch

from portbench.core import port

FAULTS = ("answer_altered", "half_batch_infer", "state_unchanged_infer",
          "state_unchanged_train", "half_batch_train", "answer_altered_train")


def _swap(obj, attr, value, stack):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    stack.callback(setattr, obj, attr, old)


@contextlib.contextmanager
def planted(fault: str):
    from diff_sal_tpu_torch import inference
    from diff_sal_tpu_torch.train import optim, train_step

    with contextlib.ExitStack() as stack:
        if fault in ("answer_altered", "half_batch_infer"):
            real = port.sampler

            def sampler(model, sampling):
                call = real(model, sampling)

                def broken(batch):
                    if fault == "answer_altered":
                        out = call(batch).clone()
                        q = out.shape[1] // 4
                        out[0, :q] = (out[0, :q] + 0.25).clamp(0.0, 1.0)
                        return out
                    half = batch["rgb"].shape[0] // 2
                    out = call({k: v[:half] for k, v in batch.items()})
                    return torch.cat([out, out.mean(0, keepdim=True).expand_as(out)])
                return broken
            _swap(port, "sampler", sampler, stack)
        elif fault == "state_unchanged_infer":
            _swap(inference, "ddim_sample", lambda schedule, fn, x, **kw: x, stack)
            _swap(inference, "dpm_solver_sample", lambda schedule, fn, x, **kw: x, stack)
        elif fault == "state_unchanged_train":
            _swap(optim.Optimizer, "step",
                  lambda self: torch.zeros((), device=self.params[0].device), stack)
        elif fault in ("half_batch_train", "answer_altered_train"):
            real_loss = train_step.training_loss

            def loss(cfg, pred, target):
                if fault == "half_batch_train":
                    half = pred.shape[0] // 2
                    return real_loss(cfg, pred[:half], target[:half])
                bump = torch.zeros_like(pred)
                bump[0] = 0.5
                return real_loss(cfg, pred + bump, target)
            _swap(train_step, "training_loss", loss, stack)
        else:
            raise KeyError(fault)
        yield
