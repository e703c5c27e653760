"""Typed configuration of the PyTorch port.

A copy of the function-changing fields of the JAX package's configs
(`diff_sal_tpu/config.py`), with the same names and defaults. The JAX
configs also carry flags that pick a TPU lowering of the same function
(`tokens3d`, `flat_dots`, `qkv_conv`, `fuse_kv`, `lane_pad`, `fold_proj`,
`stem_mode`, `skip_pool`, `attn_softmax`, `use_pallas_attention`, the
decoder's `upembed_phase`, `pool_reduce`, `conv_wg_dots`, `fused_tail`):
the port builds each of those functions once and has none of them. Four
lowering flags are kept, with the JAX defaults, because each routes to a
hand-written kernel of its own: `MViTConfig.cls_stream` (on: the cls
token rides its own stream and MViT's attention runs through kernel K1;
off: the token-concat layout, cls at row 0 of every head, through kernel
K12), `MViTConfig.pool_mode="pallas"` (the attention pools through kernel
K11; as in JAX it takes effect only with `cls_stream`, the token-concat
layout always pools by convolution), `SalUNetConfig.fused_attn` (the
decoder's CvT attention through K7 at eval) and
`SalUNetConfig.head_lowres` (the decoder head as conv-at-low-res through
K9 at eval). The training step's fields (dequantization, losses,
optimizer, dropout, drop-path, the train-time dead-frame cut, EMA) and
the DPM-Solver settings of `SamplingConfig` and the trainer's epochs,
logging and evaluation noise are here, and `MeshConfig`, the layout of
the data-parallel ranks (`parallel/mesh.py`). JAX's `SamplingConfig` also lists
`dpm_solver_type`, `dpm_solver_atol` and `dpm_solver_rtol`, which nothing
in the JAX package reads (its `adaptive_sample` takes `atol` and `rtol`
as arguments, and its `dpm_solver_sample` raises on
`dpm_solver_method="adaptive"`): the port has none of them.
`MViTConfig.mlp_quant` selects int8 block-MLP weights (`ops/quant.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataTransformConfig:
    """Pixel-space transform of saliency maps (reference
    `cfgs/diffusion.yml:1-8`); the fields the inverse transform reads."""

    logit_transform: bool = False
    uniform_dequantization: bool = False
    gaussian_dequantization: bool = True
    rescaled: bool = False


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Forward-process definition (reference `cfgs/diffusion.yml:24-28`)."""

    beta_schedule: str = "cosine"
    beta_start: float = 0.0001
    beta_end: float = 0.02
    num_diffusion_timesteps: int = 1000


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Training-loss switches (reference `cfgs/diffusion.yml:39-51`); the
    default is MSE only."""

    loss_kl: bool = False
    kl_weight: float = 1.0
    loss_mse: bool = True
    mse_weight: float = 1.0
    loss_ce: bool = False
    ce_weight: float = 1.0
    loss_cc: bool = False
    cc_weight: float = -0.1
    loss_sim: bool = False
    sim_weight: float = -0.1
    loss_nss: bool = False
    nss_weight: float = -0.1


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Adam + MultiStepLR + global-norm clip (reference
    `cfgs/diffusion.yml:53-60`, `util/utils.py:116-123`)."""

    optimizer: str = "adam"
    lr: float = 1e-4
    beta1: float = 0.9
    weight_decay: float = 0.0
    eps: float = 1e-8
    grad_clip: float = 1.0
    # MultiStepLR milestones are fractions of total epochs: [0.5E, 0.75E], gamma 0.1
    milestone_fracs: Tuple[float, ...] = (0.5, 0.75)
    gamma: float = 0.1


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """Training-loop knobs (reference `cfgs/diffusion.yml:30-37`)."""

    batch_size: int = 48
    n_epochs: int = 3
    n_epochs_for_av_data: int = 4
    log_freq: int = 200
    training_target: str = "x0"  # "x0" | "noise"
    # reference quirk: one shared scalar t per batch (diffusion_trainer.py:111-114)
    shared_timestep_per_batch: bool = True
    seed: int = 0
    # parameter EMA, off as in the reference (cfgs/diffusion.yml:21)
    ema: bool = False
    ema_rate: float = 0.9999
    # evaluation noise: True draws it from a fixed seed, so that repeated
    # evaluations rank checkpoints on the same noise; False draws a fresh
    # seed per evaluation, as the reference's per-batch randn does
    # (diffusion_trainer.py:118-120)
    eval_fixed_rng: bool = True


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Inference sampler knobs (reference `cfgs/diffusion.yml:63-77`)."""

    skip_type: str = "logSNR"  # logSNR | time_uniform | time_quadratic
    sample_type: str = "ddim"  # ddim | ddpm | dpmsolver | dpmsolver++
    timesteps: int = 1
    dpm_solver_order: int = 2
    denoise: bool = True
    dpm_solver_method: str = "multistep"  # multistep | singlestep
    lower_order_final: bool = False
    thresholding: bool = False
    eta: float = 0.0


@dataclasses.dataclass(frozen=True)
class MViTConfig:
    """MViTv2 video encoder (reference `models/mvit.py:795-1152`)."""

    embed_dims: int = 96
    num_layers: int = 16
    num_heads: int = 1
    downscale_indices: Tuple[int, ...] = (1, 3, 14)
    spatial_size: Tuple[int, int] = (224, 384)
    temporal_size: int = 16
    in_channels: int = 3
    out_scales: Tuple[int, ...] = (0, 1, 2, 3)
    pool_kernel: Tuple[int, int, int] = (3, 3, 3)
    dim_mul: int = 2
    head_mul: int = 2
    adaptive_kv_stride: Tuple[int, int, int] = (1, 8, 8)
    rel_pos_embed: bool = True
    residual_pooling: bool = True
    with_cls_token: bool = True
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    # rel-pos table lengths come from the 224x224 pretrain grid
    rel_pos_spatial_size: int = 224
    # MLP activation: "tanh" approximation (default) | "exact" erf GELU
    gelu: str = "tanh"
    # int8 block-MLP weights, an eval-time deployment transform
    # (ops/quant.py): "none" | "w8" (int8 weights, f32 accumulation) |
    # "w8a8" (int8 weights and per-row int8 activations, int32 products);
    # quantised weights come from quantize_state_dict over an fp state_dict
    mlp_quant: str = "none"
    # cls token on its own (B, 1, C) stream, spatial query rows through
    # kernel K1 (ops/attention.py) | False: the token-concat layout, cls at
    # row 0 of every head, through kernel K12
    cls_stream: bool = True
    # attention-pool lowering: "conv" (cuDNN depthwise conv3d) | "pallas"
    # (kernel K11, ops/pool.py; cls_stream only, as in JAX); JAX's
    # "stencil" is the conv's function
    pool_mode: str = "conv"
    # recompute each block in the backward pass (torch.utils.checkpoint):
    # the same function and gradients, less memory for a larger batch
    remat: bool = False

    @classmethod
    def small(cls, **kw) -> "MViTConfig":
        return cls(num_layers=16, downscale_indices=(1, 3, 14), **kw)

    @classmethod
    def tiny(cls, **kw) -> "MViTConfig":
        return cls(num_layers=10, downscale_indices=(1, 3, 8), **kw)

    @classmethod
    def dryrun(cls, **kw) -> "MViTConfig":
        return cls(num_layers=7, downscale_indices=(1, 3, 5), **kw)

    @classmethod
    def base(cls, **kw) -> "MViTConfig":
        return cls(num_layers=24, downscale_indices=(2, 5, 21), **kw)

    @classmethod
    def large(cls, **kw) -> "MViTConfig":
        return cls(embed_dims=144, num_layers=48, num_heads=2,
                   downscale_indices=(2, 8, 44), **kw)


@dataclasses.dataclass(frozen=True)
class AudioAttnConfig:
    """AudioAttnNet's effective 1-layer pre-norm transformer over the raw
    512-d VGGish tokens (reference `models/audio_attention.py:93-143`)."""

    dim: int = 512
    depth: int = 1
    heads: int = 2
    dim_head: int = 64
    mlp_dim: int = 256
    dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class VGGishConfig:
    """VGGish conv trunk (reference `models/vggish.py:96-128`)."""

    layers: Tuple = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M")
    in_channels: int = 1


@dataclasses.dataclass(frozen=True)
class SalUNetConfig:
    """Saliency-UNet diffusion decoder (reference `cfgs/audio_visual.py:50-82`)."""

    img_size: Tuple[int, int] = (224, 384)
    image_based: bool = True
    mid_num_stages: int = 4
    temporal_list: Tuple[int, ...] = (5, 5, 5, 5)
    ori_embed_dim: int = 768
    down_embed_dim: int = 96
    patch_size: Tuple[int, ...] = (0, 3, 3, 3)
    up_channel: Tuple[int, ...] = (768, 384, 192, 96)
    num_heads: Tuple[int, ...] = (2, 2, 2, 2)
    mlp_ratio: Tuple[float, ...] = (2.0, 2.0, 2.0, 2.0)
    kernel_kv: Tuple[int, ...] = (2, 4, 8, 16)
    stride_kv: Tuple[int, ...] = (2, 4, 8, 16)
    audio_dim: int = 512
    noise_ch: int = 96
    # ResnetBlock dropout of the noise encoder (train only)
    dropout: float = 0.1
    # DropPath on each stage's MLP branch (train only)
    drop_path_rate: Tuple[float, ...] = (0.15, 0.15, 0.15, 0.15)
    # MLP activation: "tanh" (default) | "exact"
    gelu: str = "tanh"
    # skip the last stage's frames 5-8, which ReduceTemp never reads: exact
    skip_dead_frames: bool = True
    # cut frames 5-8 at every stage (eval): APPROXIMATE, the stage-1..3 av
    # gates then average 5 frames instead of 9 (JAX `config.py:373-389`)
    skip_dead_frames_all: bool = True
    # apply the every-stage cut inside the training step too (JAX
    # `config.py:390-404`): approximate in the same way, default on
    skip_dead_frames_train: bool = True
    # eval: the CvT cross-attention through kernel K7 (ops/attention.py)
    fused_attn: bool = False
    # eval: the mt_proj head as conv-at-low-res with BatchNorm folded,
    # through kernel K9 (ops/resize.py)
    head_lowres: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Top-level VideoSaliencyModel composition (reference
    `models/diff_model.py:8-114`)."""

    visual: Optional[MViTConfig] = dataclasses.field(default_factory=MViTConfig.small)
    audio: Optional[VGGishConfig] = None
    spatiotemp: Optional[AudioAttnConfig] = None
    decoder: SalUNetConfig = dataclasses.field(default_factory=SalUNetConfig)
    # compute dtype of the heavy math; parameters always live in float32
    compute_dtype: str = "float32"
    # statistics for uint8 rgb input: "imagenet" | "stavis"
    uint8_norm: str = "imagenet"

    @classmethod
    def visual_only(cls, **kw) -> "ModelConfig":
        return cls(visual=MViTConfig.small(), audio=None, spatiotemp=None, **kw)

    @classmethod
    def audio_visual(cls, **kw) -> "ModelConfig":
        return cls(visual=MViTConfig.small(), audio=VGGishConfig(),
                   spatiotemp=AudioAttnConfig(), **kw)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The parallel layout (JAX `config.py:464-477`): the reference's one
    strategy, data parallelism over its ranks (train_dhf1k.py:38-61,
    model.py:13-15). `num_data=-1` takes every rank of the process group;
    the model axis is one wide, since tensor-parallel sharding is not
    ported: `num_model` above 1 raises."""

    data_axis: str = "data"
    model_axis: str = "model"
    num_data: int = -1  # -1 => all ranks
    num_model: int = 1

    def __post_init__(self):
        if self.num_model != 1:
            raise NotImplementedError(
                f"num_model={self.num_model}: tensor-parallel sharding is not ported; "
                "the port's ranks split the batch only")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Everything one training or evaluation run reads."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig.visual_only)
    data_transform: DataTransformConfig = dataclasses.field(default_factory=DataTransformConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def visual_experiment(**kw) -> ExperimentConfig:
    return ExperimentConfig(model=ModelConfig.visual_only(), **kw)


def audio_visual_experiment(**kw) -> ExperimentConfig:
    return ExperimentConfig(model=ModelConfig.audio_visual(), **kw)


def from_fields(obj):
    """This module's config equal to any dataclass config of the same class
    name (e.g. one of the JAX package's), recursively, keeping only the
    fields this module defines."""
    if not dataclasses.is_dataclass(obj):
        return obj
    cls = globals()[type(obj).__name__]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: from_fields(getattr(obj, f.name))
                  for f in dataclasses.fields(obj) if f.name in names})
