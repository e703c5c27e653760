"""The reference's released checkpoints -> the port's `state_dict` (the
import direction of the JAX package's `train/convert.py`).

Three kinds, as JAX's `scripts/import_reference_ckpt.py` reads them: a
DiffSal `best.pth` (a `module.`-prefixed VideoSaliencyModel, reference
model.py:17-22), a Kinetics MViT (`backbone.`-prefixed, reference
mvit.py:1072-1101) and `vggish.pth` (reference vggish.py:114-123).

The port's modules carry the reference's torch names and layouts, so the
layout rules of JAX's converter are the identity here. What stays is the
choice of what is read, which follows JAX's converters tensor for tensor:
where JAX indexes a key (`sd[...]`) a missing one raises KeyError naming
it, and where JAX tests for presence (a block's `proj`, a stage norm
`norm{s}`, `align_conv`, `nin_shortcut`, a stage's `patch_embed`, VGGish's
`embeddings.{0,2,4}`, AudioAttnNet's layers) so does the port. Two points
of the reference's layout are kept: the decoder's CvT `conv_proj_*`
weights stay full Conv3d tensors (the port uses their centre temporal
slice, as JAX's `depthwise_conv3d_center_slice_to_2d` does), and rel-pos
tables are copied verbatim (both packages resize them at run time).
BatchNorm's `num_batches_tracked` is taken where the source has it and
set to 0 where it does not.

Each converter returns the state_dict of the tensors it reads and a
`Report`: the count of source tensors loaded, and the keys dropped, by
reason: VGGish's FC head (`embeddings.*`, which the port does not build),
AudioAttnNet's dead `to_patch_embedding.*` and `pos_embedding`, a Kinetics
file's keys outside `backbone.` (its classifier), keys outside the four
sub-networks, and keys no converter reads.

The output is the fp model's state_dict: a model with `mlp_quant` takes it
through `ops/quant.quantize_state_dict`, as it takes any fp state_dict.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

SUBNETS = ("visual_net", "audio_net", "spatiotemp_net", "decoder_net")
KINDS = ("full", "mvit", "vggish")

VGGISH_HEAD = "VGGish embeddings.* (its FC head, not built by the port)"
AUDIO_ATTN_DEAD = "AudioAttnNet to_patch_embedding.* and pos_embedding (computed and discarded)"
OUTSIDE_BACKBONE = "outside backbone. (the Kinetics classifier and the rest)"
OTHER = "outside the four sub-networks"
UNREAD = "not read by the converter"

# torch Sequential indices of the VGGish convs (reference models/vggish.py)
VGGISH_CONV_IDS = (0, 3, 6, 8, 11, 13)

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Report:
    loaded: int = 0  # source tensors read into the state_dict
    dropped: Dict[str, List[str]] = dataclasses.field(default_factory=dict)

    def drop(self, reason: str, keys):
        keys = sorted(keys)
        if keys:
            self.dropped.setdefault(reason, []).extend(keys)

    def merge(self, other: "Report", prefix: str = ""):
        self.loaded += other.loaded
        for reason, keys in other.dropped.items():
            self.drop(reason, [prefix + k for k in keys])

    def lines(self) -> List[str]:
        return [f"loaded {self.loaded} tensors"] + [
            f"dropped {len(keys)} ({reason}): {', '.join(keys)}"
            for reason, keys in self.dropped.items()]


class _Reader:
    """Reads a source dict as JAX's converters index it; `name` prefixes the
    key a KeyError names."""

    def __init__(self, sd: Mapping[str, torch.Tensor], name: str = ""):
        self.sd, self.name, self.out = sd, name, {}
        self.discarded: Dict[str, List[str]] = {}  # read as JAX reads, not kept

    def has(self, key: str) -> bool:
        return key in self.sd

    def take(self, key: str, fn: Optional[Callable] = None):
        if key not in self.sd:
            raise KeyError(f"{self.name}{key}: missing from the checkpoint")
        v = self.sd[key]
        self.out[key] = fn(v) if fn else v

    def take_wb(self, prefix: str):
        self.take(prefix + ".weight")
        self.take(prefix + ".bias")

    def bn(self, prefix: str):
        """BatchNorm: weight, bias and running statistics as JAX reads them;
        torch's counter from the source where it has one, else 0."""
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            self.take(f"{prefix}.{leaf}")
        counter = prefix + ".num_batches_tracked"
        self.out[counter] = (self.sd[counter].reshape(()) if counter in self.sd
                             else torch.tensor(0, dtype=torch.long))

    def discard(self, reason: str, keys: List[str]):
        for k in keys:
            del self.out[k]
        self.discarded.setdefault(reason, []).extend(keys)

    def finish(self, dead: Optional[Tuple[str, Callable[[str], bool]]] = None
               ) -> Tuple[StateDict, Report]:
        rep = Report(loaded=sum(not k.endswith("num_batches_tracked") for k in self.out))
        for reason, keys in self.discarded.items():
            rep.drop(reason, keys)
        read = set(self.out).union(*self.discarded.values())
        rest = [k for k in self.sd if k not in read]
        if dead is not None:
            reason, is_dead = dead
            rep.drop(reason, [k for k in rest if is_dead(k)])
            rest = [k for k in rest if not is_dead(k)]
        rep.drop(UNREAD, rest)
        return dict(self.out), rep


def load_torch_state_dict(path: str) -> StateDict:
    """A .pth file's tensors on the CPU, under `"state_dict"` where the file
    wraps them (JAX `load_torch_state_dict`). The file comes from outside
    the program, so torch's restricted unpickler reads it
    (`weights_only=True`: tensors and plain containers; JAX's loader
    unpickles anything): a file that pickles other objects is refused."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def convert_mvit(sd: Mapping[str, torch.Tensor], num_layers: int = 16, name: str = ""
                 ) -> Tuple[StateDict, Report]:
    """An MViT state_dict (keys stripped of `backbone.` / `visual_net.`) ->
    the port's MViT entries (JAX `convert_mvit`)."""
    r = _Reader(sd, name)
    r.take_wb("patch_embed.projection")
    r.take("cls_token", lambda v: v.reshape(1, 1, -1))
    for i in range(num_layers):
        p = f"blocks.{i}."
        for m in ("norm1", "norm2", "mlp.fc1", "mlp.fc2", "attn.qkv", "attn.proj"):
            r.take_wb(p + m)
        for a in ("t", "h", "w"):
            r.take(p + f"attn.rel_pos_{a}")
        for a in ("q", "k", "v"):
            r.take(p + f"attn.pool_{a}.weight")
            r.take_wb(p + f"attn.norm_{a}")
        if r.has(p + "proj.weight"):
            r.take_wb(p + "proj")
    for s in range(4):
        if r.has(f"norm{s}.weight"):
            r.take_wb(f"norm{s}")
    return r.finish()


def convert_vggish(sd: Mapping[str, torch.Tensor], name: str = "") -> Tuple[StateDict, Report]:
    """vggish.pth -> the port's VGGish trunk (JAX `convert_vggish`). JAX
    reads the FC head where present; the port does not build it and
    reports those tensors dropped."""
    r = _Reader(sd, name)
    for lid in VGGISH_CONV_IDS:
        r.take_wb(f"features.{lid}")
    for lid in (0, 2, 4):
        if r.has(f"embeddings.{lid}.weight"):
            r.take_wb(f"embeddings.{lid}")
            r.discard(VGGISH_HEAD, [f"embeddings.{lid}.weight", f"embeddings.{lid}.bias"])
    return r.finish()


def _audio_attn_dead(key: str) -> bool:
    return key.startswith("to_patch_embedding.") or key == "pos_embedding"


def convert_audio_attn(sd: Mapping[str, torch.Tensor], name: str = ""
                       ) -> Tuple[StateDict, Report]:
    """AudioAttnNet (JAX `convert_audio_attn`): its transformer layers and
    final norm; the dead patch and position embeddings are dropped."""
    r = _Reader(sd, name)
    i = 0
    while r.has(f"transformer.layers.{i}.0.norm.weight"):
        att, ff = f"transformer.layers.{i}.0.", f"transformer.layers.{i}.1."
        r.take_wb(att + "norm")
        r.take(att + "to_qkv.weight")
        r.take_wb(att + "to_out.0")
        for m in ("net.0", "net.1", "net.4"):
            r.take_wb(ff + m)
        i += 1
    r.take_wb("transformer.norm")
    return r.finish(dead=(AUDIO_ATTN_DEAD, _audio_attn_dead))


def convert_salunet(sd: Mapping[str, torch.Tensor], num_stages: int = 4, name: str = ""
                    ) -> Tuple[StateDict, Report]:
    """The SalUNet decoder (JAX `convert_salunet`). The CvT `conv_proj_*`
    weights stay whole Conv3d tensors: the port reads their centre slice."""
    r = _Reader(sd, name)
    for j in (0, 1):
        r.take_wb(f"temb.dense.{j}")
    r.take_wb("conv_in")
    r.take_wb("down1.conv")
    for i in range(3):
        rb = f"res_encoder.{i}.0."
        for m in ("norm1", "conv1", "temb_proj", "norm2", "conv2"):
            r.take_wb(rb + m)
        if r.has(rb + "nin_shortcut.weight"):
            r.take_wb(rb + "nin_shortcut")
        r.take_wb(f"res_encoder.{i}.1.conv")
    for i in range(num_stages):
        sp = f"invpt_decoder.mid_stages.{i}."
        if r.has(sp + "patch_embed.0.proj.1.weight"):
            for ci, bi in ((1, 2), (4, 5)):
                r.take(sp + f"patch_embed.0.proj.{ci}.weight")
                r.bn(sp + f"patch_embed.0.proj.{bi}")
        bp = sp + "blocks.0."
        for m in ("norm", "norm2", "mlp.fc1", "mlp.fc2"):
            r.take_wb(bp + m)
        if r.has(bp + "align_conv.weight"):
            r.take_wb(bp + "align_conv")
        for a in ("q", "k", "v"):
            r.take(bp + f"attn.conv_proj_{a}.conv.weight")
            r.take_wb(bp + f"attn.conv_proj_{a}.bn")
            r.take_wb(bp + f"attn.proj_{a}")
        r.take_wb(bp + "attn.proj")
        r.take_wb(f"invpt_decoder.norm_mts.{i}")
        r.take(f"invpt_decoder.redu_chan_up.{i}.proj.0.weight")
    r.take_wb("invpt_decoder.mt_proj.0")
    r.bn("invpt_decoder.mt_proj.1")
    r.take_wb("logits.linear_pred")
    return r.finish()


def split_diffsal_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, StateDict]:
    """A full DiffSal best.pth -> one dict per sub-network (keys stripped
    of `module.` and the sub-network's name) and `other` (JAX
    `split_diffsal_state_dict`)."""
    out: Dict[str, StateDict] = {k: {} for k in SUBNETS + ("other",)}
    for k, v in sd.items():
        k2 = k[len("module."):] if k.startswith("module.") else k
        sub = next((s for s in SUBNETS if k2.startswith(s + ".")), None)
        if sub is None:
            out["other"][k2] = v
        else:
            out[sub][k2[len(sub) + 1:]] = v
    return out


def convert_full(sd: Mapping[str, torch.Tensor], num_mvit_layers: int = 16
                 ) -> Tuple[StateDict, Report]:
    """A DiffSal best.pth -> the VideoSaliencyModel's state_dict (JAX
    `convert_video_saliency_model`): each sub-network the file holds."""
    parts = split_diffsal_state_dict(sd)
    convert = {"visual_net": functools.partial(convert_mvit, num_layers=num_mvit_layers),
               "audio_net": convert_vggish, "spatiotemp_net": convert_audio_attn,
               "decoder_net": convert_salunet}
    out: StateDict = {}
    rep = Report()
    for sub in SUBNETS:
        if parts[sub]:
            part, r = convert[sub](parts[sub], name=sub + ".")
            out.update({f"{sub}.{k}": v for k, v in part.items()})
            rep.merge(r, sub + ".")
    rep.drop(OTHER, parts["other"])
    return out, rep


def convert_checkpoint(sd: Mapping[str, torch.Tensor], kind: str = "full",
                       num_mvit_layers: int = 16) -> Tuple[StateDict, Report]:
    """A released checkpoint of `kind` -> entries of the VideoSaliencyModel's
    state_dict: the whole model for "full"; `visual_net.*` for "mvit" (the
    keys under `backbone.`, or the whole file where none is, as JAX's
    script takes it); `audio_net.*` for "vggish". The two partial kinds
    serve `Trainer.warm_start`."""
    if kind == "full":
        return convert_full(sd, num_mvit_layers)
    if kind == "mvit":
        backbone = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
        part, rep = convert_mvit(backbone or sd, num_mvit_layers)
        if backbone:
            rep.drop(OUTSIDE_BACKBONE, [k for k in sd if not k.startswith("backbone.")])
        sub = "visual_net"
    elif kind == "vggish":
        part, rep = convert_vggish(sd)
        sub = "audio_net"
    else:
        raise ValueError(f"kind={kind!r}; expected one of {KINDS}")
    return {f"{sub}.{k}": v for k, v in part.items()}, rep

