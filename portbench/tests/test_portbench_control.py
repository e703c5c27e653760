"""The control of `correct`: the reference put in the port's place and
computed with every product's operands in float8 e4m3 (the precision
below the configurations' bf16) has to come out not correct. At a tiny
size on the CPU through a whole run, and at each cell's own size on the
card (marked `cuda`) over three seeds, as the limits were set."""

import pytest
import torch

from portbench.core import port, spec
from portbench.reference import model as ref_model
from portbench.tests import rehearsal

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


class _ReferenceInPortsPlace:
    """The reference model in float8 where a run builds the port's."""

    def __enter__(self):
        from portbench.core import check

        self.saved = port.build_model, port.Hooks
        real_sampler = port.sampler
        self.real_maps = real_maps = check.reference_maps

        def reference_maps(*args):  # the yardstick itself stays in float32
            ref_model.LOWP["on"] = False
            try:
                return real_maps(*args)
            finally:
                ref_model.LOWP["on"] = True
        check.reference_maps = reference_maps

        def sampler(model, sampling):
            if not isinstance(model, ref_model.DiffSal):
                return real_sampler(model, sampling)
            from portbench.reference import diffusion

            return lambda b: diffusion.sample(model, diffusion.Schedule(), sampling, b["rgb"],
                                              b.get("audio"), b["noise"])
        port.build_model, port.Hooks = _loaded, _NoHooks
        self.saved_sampler, port.sampler = real_sampler, sampler
        ref_model.LOWP["on"] = True
        return self

    def __exit__(self, *exc):
        from portbench.core import check

        check.reference_maps = self.real_maps
        port.build_model, port.Hooks = self.saved
        port.sampler = self.saved_sampler
        ref_model.LOWP["on"] = False


def _loaded(model_cfg, weights, device, train):
    model = ref_model.build(model_cfg, device)
    model.load_state_dict(weights)
    return model.train(train)


class _NoHooks:
    def __init__(self, model):
        self.counts, self.bounds, self.trace = {"denoise": 0}, [], False

    def remove(self):
        pass


def test_the_control_fails_a_tiny_inference_run_on_the_cpu():
    # the reference compares against itself in f32 after the window: the
    # float8 run in the port's place has to miss a limit
    with torch.no_grad(), _ReferenceInPortsPlace():
        r = rehearsal.run_cell("av_ddim_b30", "bfloat16")
    assert r["correct"] is False, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_each_cell_at_its_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")
    from portbench.core import check
    from portbench.tools import readings

    w = spec.workload(cell)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    port.build_kernels()
    for seed in (3000000201, 3000000202, 3000000203):
        r = readings.reading(w, cfg, traffic, seed, control=True)
        assert not check.verdict(r["numbers"], w["limits"]), (seed, r["numbers"])
