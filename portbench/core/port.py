"""The system under test, `diff_sal_tpu_torch`, as the benchmark drives it:
its model built from a configuration file, its entry points
(`inference.sample_saliency`, `train.train_step.make_train_step`), and
the hooks the traced slice reads: profiler ranges around the model's
`encode_visual`, `encode_audio`, `denoise` and `forward`, a count of
denoiser calls, and a record of each call of the port's kernel wrappers
(its bound, from `roofline.bound_terms`) inside a range of its own.
This is the only module of the benchmark that imports the port."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from portbench.core import roofline

# the wrappers that launch the port's hand-written kernels: (module, attribute)
KERNEL_WRAPPERS = {
    "bias_attention": ("attention", "bias_attention"),
    "bias_attention_bwd": ("attention", "bias_attention_bwd"),
    "layer_norm": ("layernorm", "layer_norm"),
    "layer_norm_bwd": ("layernorm", "layer_norm_bwd"),
    "block_tail": ("mlp", "block_tail"),
    "bilinear_resize_sum": ("resize", "bilinear_resize_sum"),
    "bilinear_resize_add": ("resize", "bilinear_resize_add"),
    "cvt_attention": ("attention", "cvt_cross_attention"),
    "resize_conv_relu": ("resize", "resize_sum_conv_relu"),
    "depthwise_pool3d": ("pool", "depthwise_pool3d"),
    "fused_bias_attention": ("attention", "fused_bias_attention"),
    "fused_bias_attention_bwd": ("attention", "fused_bias_attention_bwd"),
}
MODEL_RANGES = ("encode_visual", "encode_audio", "denoise", "forward")


def _tuples(v):
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    if isinstance(v, dict):
        return {k: _tuples(x) for k, x in v.items()}
    return v


def model_config(model_cfg: dict):
    """The port's ModelConfig of a configuration file's `model` block."""
    from diff_sal_tpu_torch import config as C

    m = _tuples(model_cfg)
    return C.ModelConfig(
        visual=C.MViTConfig(**m["visual"]),
        audio=C.VGGishConfig(**m["audio"]) if m.get("audio") else None,
        spatiotemp=C.AudioAttnConfig(**m["spatiotemp"]) if m.get("spatiotemp") else None,
        decoder=C.SalUNetConfig(**m["decoder"]),
        compute_dtype=m["compute_dtype"], uint8_norm=m["uint8_norm"])


def build_model(model_cfg: dict, weights: Dict[str, torch.Tensor], device, train: bool):
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel

    with torch.device(device):
        model = VideoSaliencyModel(model_config(model_cfg))
    model.load_state_dict(weights, strict=True)
    return model.train(train)


def build_kernels() -> Dict[str, float]:
    """Build (or find in the port's own cache inside the checkout) every
    kernel library."""
    from diff_sal_tpu_torch.ops import kernels

    return kernels.build_all()


def sampler(model, sampling: dict) -> Callable:
    """call(batch) -> the batch's maps on the device, through
    `inference.sample_saliency` with the traffic's sampler."""
    from diff_sal_tpu_torch.config import DataTransformConfig, SamplingConfig
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.inference import sample_saliency

    schedule = make_schedule()
    if sampling["kind"] == "ddim":
        s = SamplingConfig(sample_type="ddim", timesteps=sampling["nfe"])
    else:
        s = SamplingConfig(sample_type=sampling["kind"], timesteps=sampling["nfe"],
                           dpm_solver_method="multistep", dpm_solver_order=sampling["order"],
                           skip_type="logSNR", denoise=True)
    data_cfg = DataTransformConfig()

    def call(batch):
        return sample_saliency(model, schedule, s, data_cfg, batch["rgb"], batch.get("audio"),
                               noise=batch["noise"])
    return call


def trainer(model, model_cfg: dict, optim: dict):
    """(step(batch, generator) -> metrics, optimizer): the port's training
    step (`make_train_step`) with its Adam + clip + MultiStepLR, as the
    visual and audio-visual experiments configure them."""
    from diff_sal_tpu_torch.config import ExperimentConfig, OptimConfig
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    cfg = ExperimentConfig(model=model_config(model_cfg))
    ocfg = dataclasses.replace(OptimConfig(), lr=optim["lr"], grad_clip=optim["grad_clip"])
    opt = make_optimizer(model, ocfg, optim["steps_per_epoch"], optim["n_epochs"])
    step = make_train_step(model, make_schedule(), cfg)

    def call(batch, generator):
        return step(opt, batch, generator)
    return call, opt


def trainable_names(model) -> List[str]:
    """The names of the parameters the optimizer holds, in its order."""
    return [n for n, p in model.named_parameters() if p.requires_grad]


class Hooks:
    """Profiler ranges and counts around the model's entry points and the
    kernel wrappers. `count` is on for the whole run, `trace` only for
    the traced slice: each wrapper call then opens a range
    `pb.k.<kernel>#<i>` and keeps its bound (bytes, seconds) under i."""

    def __init__(self, model):
        from diff_sal_tpu_torch.ops import attention, layernorm, mlp, pool, resize

        mods = {"attention": attention, "layernorm": layernorm, "mlp": mlp, "pool": pool,
                "resize": resize}
        self.trace = False
        self.counts = {n: 0 for n in MODEL_RANGES}
        self.bounds: List[float] = []
        self._restore = []
        for kernel, (mod, attr) in KERNEL_WRAPPERS.items():
            self._wrap(mods[mod], attr, self._kernel(kernel, getattr(mods[mod], attr)))
        for name in MODEL_RANGES:
            self._wrap(model, name, self._range(name, getattr(model, name)))

    def _wrap(self, obj, attr, fn):
        self._restore.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, fn)

    def _range(self, name, fn):
        def call(*args, **kw):
            self.counts[name] += 1
            if not self.trace:
                return fn(*args, **kw)
            with torch.profiler.record_function(f"pb.{name}"):
                return fn(*args, **kw)
        return call

    def _kernel(self, kernel, fn):
        def call(*args, **kw):
            if not self.trace:
                return fn(*args, **kw)
            i = len(self.bounds)
            self.bounds.append(roofline.bound_seconds(kernel, args))
            with torch.profiler.record_function(f"pb.k.{kernel}#{i}"):
                return fn(*args, **kw)
        return call

    def remove(self):
        for obj, attr, old in reversed(self._restore):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
