"""Importing the reference's released checkpoints (`train/convert.py`,
`scripts/import_reference_ckpt.py`) against the JAX package's
`train/convert.py`, on the CPU in f32, at the small AV size.

No released weights are in the repository, so each test writes its own
reference-format file from JAX's random tiny variables: JAX's
`export_mvit` and `export_salunet`, and the bridge's `export_vggish` and
`export_audio_attn` for the two parts JAX exports nothing of. The full
file is `module.`-prefixed and holds what a real best.pth holds beyond the
port's tensors: VGGish's FC head (`embeddings.{0,2,4}`), AudioAttnNet's
dead `to_patch_embedding.*` and `pos_embedding`, non-zero off-centre
temporal slices in every CvT `conv_proj_q` (kt = 3), a BatchNorm counter
and one key outside the sub-networks. The port's import, loaded strictly,
gives JAX's model on `convert_video_saliency_model` of the same file:
denoiser output and pyramid within 1e-4 (the per-network f32 bound of
tests/test_torch_models.py); it loads as many tensors as JAX's converter
reads into the tree its model applies.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.models.diff_model import VideoSaliencyModel as JModel
from diff_sal_tpu.models.mvit import MViT as JMViT
from diff_sal_tpu.models.vggish import VGGish as JVGGish
from diff_sal_tpu.train import convert as jconvert
from diff_sal_tpu_torch import bridge
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel
from diff_sal_tpu_torch.models.mvit import MViT
from diff_sal_tpu_torch.models.vggish import VGGish
from diff_sal_tpu_torch.scripts import import_reference_ckpt
from diff_sal_tpu_torch.train import convert
from test_torch_models import full_model_variables, random_variables, small_av_config

ATOL = 1e-4
B = 2


def _leaves(tree) -> int:
    return len(jax.tree_util.tree_leaves(tree))


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v))


def planted(rng):
    """The keys a real best.pth holds that the port does not build, and
    the off-centre CvT slices: (extra entries, the dropped report wanted)."""
    extra = {}
    for lid, (o, i) in zip((0, 2, 4), ((64, 96), (32, 64), (8, 32))):
        extra[f"module.audio_net.embeddings.{lid}.weight"] = rng.randn(o, i)
        extra[f"module.audio_net.embeddings.{lid}.bias"] = rng.randn(o)
    extra["module.spatiotemp_net.to_patch_embedding.1.weight"] = rng.randn(512, 512)
    extra["module.spatiotemp_net.to_patch_embedding.1.bias"] = rng.randn(512)
    extra["module.spatiotemp_net.pos_embedding"] = rng.randn(1, 10, 512)
    extra["module.step_counter"] = np.array([5.0])
    drop = {
        convert.VGGISH_HEAD: sorted(k[len("module."):] for k in extra if "embeddings." in k),
        convert.AUDIO_ATTN_DEAD: sorted(k[len("module."):] for k in extra
                                        if k.startswith("module.spatiotemp_net.")),
        convert.OTHER: ["step_counter"],
    }
    return {k: np.asarray(v, np.float32) for k, v in extra.items()}, drop


def reference_file(variables, cfg, rng):
    """A reference-format best.pth state_dict (numpy), `module.`-prefixed."""
    p, s = variables["params"], variables["batch_stats"]
    parts = {"visual_net": jconvert.export_mvit(p["visual_net"], cfg.visual.num_layers),
             "audio_net": bridge.export_vggish(p["audio_net"]),
             "spatiotemp_net": bridge.export_audio_attn(p["spatiotemp_net"]),
             "decoder_net": jconvert.export_salunet(p["decoder_net"], s["decoder_net"])}
    sd = {f"module.{sub}.{k}": np.array(v, np.float32) for sub, part in parts.items()
          for k, v in part.items()}
    n_offcentre = 0
    for k, v in sd.items():
        if k.endswith("conv_proj_q.conv.weight"):
            assert v.shape[2] == 3 and not v[:, :, 0].any()
            v[:, :, 0] = rng.randn(*v[:, :, 0].shape)
            v[:, :, 2] = rng.randn(*v[:, :, 2].shape)
            n_offcentre += 1
    assert n_offcentre == 4
    sd["module.decoder_net.invpt_decoder.mt_proj.1.num_batches_tracked"] = np.array(7)
    extra, drop = planted(rng)
    sd.update(extra)
    return sd, drop


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    cfg = small_av_config()
    jm, variables = full_model_variables(cfg, seed=61)
    rng = np.random.RandomState(62)
    sd_np, drop = reference_file(variables, cfg, rng)
    path = str(tmp_path_factory.mktemp("ckpt") / "best.pth")
    # the reference trainer's own file layout
    torch.save({"state_dict": {k: _t(v) for k, v in sd_np.items()}, "optim_dict": {},
                "epoch": 3, "step": 12}, path)
    return {"cfg": cfg, "jm": jm, "variables": variables, "path": path, "drop": drop}


def _inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    h, w = cfg.decoder.img_size
    return (rng.randn(B, 16, h, w, 3).astype(np.float32),
            rng.randn(B, 9, h // 2, w // 2, 1).astype(np.float32),
            rng.randn(B, h, w, 1).astype(np.float32), np.array([0.0, 500.0], np.float32))


def _jax_outputs(jm, variables, inputs):
    def fwd(m, rgb, audio, x, t):
        feats = m.encode_visual(rgb)
        return m.denoise(x, t, feats, m.encode_audio(audio)), feats

    return jax.jit(lambda v, *a: jm.apply(v, *a, method=fwd))(variables, *inputs)


def test_full_import_matches_jax_convert(full):
    cfg, jm = full["cfg"], full["jm"]
    L = cfg.visual.num_layers
    src = convert.load_torch_state_dict(full["path"])
    sd, report = convert.convert_full(src, num_mvit_layers=L)
    model = VideoSaliencyModel(pc.from_fields(cfg)).eval()
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())
    assert report.dropped == full["drop"], report.dropped
    assert int(sd["decoder_net.invpt_decoder.mt_proj.1.num_batches_tracked"]) == 7
    assert int(sd["decoder_net.invpt_decoder.mid_stages.1.patch_embed.0.proj.2"
                  ".num_batches_tracked"]) == 0

    jvars = jconvert.convert_video_saliency_model(src, num_mvit_layers=L)
    # JAX reads the VGGish head into fc1-3, which its model never applies
    assert set(jvars["params"]["audio_net"]) - set(full["variables"]["params"]["audio_net"]) \
        == {"fc1", "fc2", "fc3"}
    used = {"params": {k: v for k, v in jvars["params"].items()},
            "batch_stats": jvars["batch_stats"]}
    used["params"]["audio_net"] = {k: v for k, v in jvars["params"]["audio_net"].items()
                                   if not k.startswith("fc")}
    assert report.loaded == _leaves(used) == _leaves(full["variables"])
    assert report.loaded + len(report.dropped[convert.VGGISH_HEAD]) == _leaves(jvars)

    inputs = _inputs(cfg, 63)
    ref_out, ref_feats = _jax_outputs(jm, jvars, inputs)
    rgb, audio, x, t = map(torch.from_numpy, inputs)
    with torch.no_grad():
        feats = model.encode_visual(rgb)
        out = model.denoise(x, t, feats, model.encode_audio(audio))
    assert [tuple(f.shape) for f in feats] == [r.shape for r in ref_feats]
    for f, r in zip(feats, ref_feats):
        np.testing.assert_allclose(f.numpy(), np.asarray(r), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL, rtol=0)
    assert float(out.std()) > 0


def test_offcentre_cvt_slices_are_kept_and_unused(full):
    """The CvT q projections stay whole Conv3d tensors: the import keeps
    the off-centre slices, and the model reads only the centre one (zeroing
    the others leaves the output bit for bit)."""
    cfg = full["cfg"]
    sd, _ = convert.convert_full(convert.load_torch_state_dict(full["path"]),
                                 cfg.visual.num_layers)
    keys = [k for k in sd if k.endswith("conv_proj_q.conv.weight")]
    assert len(keys) == 4 and all(bool(sd[k][:, :, 0].abs().gt(0).all()) for k in keys)
    centre = dict(sd)
    for k in keys:
        w = sd[k].clone()
        w[:, :, 0] = w[:, :, 2] = 0
        centre[k] = w
    rgb, audio, x, t = map(torch.from_numpy, _inputs(cfg, 64))
    outs = []
    for s in (sd, centre):
        m = VideoSaliencyModel(pc.from_fields(cfg)).eval()
        m.load_state_dict(s, strict=True)
        with torch.no_grad():
            outs.append(m({"rgb": rgb, "input": x, "audio": audio}, t))
    assert torch.equal(outs[0], outs[1])


@pytest.fixture(scope="module")
def kinetics():
    """A tiny MViT's reference-format entries, JAX's MViT on
    `convert_mvit` of them and its pyramid."""
    cfg = jc.MViTConfig.tiny(spatial_size=(32, 48))
    x = np.random.RandomState(65).randn(B, 16, 32, 48, 3).astype(np.float32)
    jm = JMViT(cfg)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 66)
    mvit = {k: _t(np.asarray(v)) for k, v in
            jconvert.export_mvit(variables["params"], cfg.num_layers).items()}
    jvars = jconvert.convert_mvit(mvit, cfg.num_layers)
    return cfg, x, mvit, jvars, jax.jit(jm.apply)(jvars, x)


@pytest.mark.parametrize("backbone", [True, False], ids=["backbone", "bare"])
def test_mvit_kind_matches_jax_convert_mvit(kinetics, backbone):
    """A Kinetics MViT: `backbone.`-prefixed with a classifier beside it
    (dropped as outside the backbone), or bare (the classifier unread), as
    JAX's script takes it (import_reference_ckpt.py:35-40)."""
    cfg, x, mvit, jvars, ref = kinetics
    head = {"cls_head.fc_cls.weight": torch.randn(400, 768), "cls_head.fc_cls.bias":
            torch.randn(400)}
    src = {**({f"backbone.{k}": v for k, v in mvit.items()} if backbone else mvit), **head}
    sd, report = convert.convert_checkpoint(src, "mvit", num_mvit_layers=cfg.num_layers)
    assert all(k.startswith("visual_net.") for k in sd)
    reason = convert.OUTSIDE_BACKBONE if backbone else convert.UNREAD
    assert report.dropped == {reason: sorted(head)}
    assert report.loaded == _leaves(jvars) == len(mvit)
    pm = MViT(pc.from_fields(cfg)).eval()
    pm.load_state_dict({k[len("visual_net."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=0)


def test_vggish_kind_matches_jax_convert_vggish():
    frames = np.random.RandomState(67).randn(4, 32, 48, 1).astype(np.float32)
    jv = JVGGish()
    vv = random_variables(jax.eval_shape(
        lambda k, x: jv.init(k, x, method=JVGGish.forward_feat), jax.random.PRNGKey(0), frames),
        68)
    src = {k: _t(v) for k, v in bridge.export_vggish(vv["params"]).items()}
    rng = np.random.RandomState(69)
    head = {}
    for lid, (o, i) in zip((0, 2, 4), ((16, 24), (16, 16), (8, 16))):
        head[f"embeddings.{lid}.weight"] = _t(rng.randn(o, i).astype(np.float32))
        head[f"embeddings.{lid}.bias"] = _t(rng.randn(o).astype(np.float32))
    sd, report = convert.convert_checkpoint({**src, **head}, "vggish")
    assert report.dropped == {convert.VGGISH_HEAD: sorted(head)}
    jvars = jconvert.convert_vggish({**src, **head})
    assert report.loaded == len(src) == _leaves(jvars) - len(head)
    pv = VGGish()
    pv.load_state_dict({k[len("audio_net."):]: v for k, v in sd.items()}, strict=True)
    ref = jax.jit(lambda v, x: jv.apply(v, x, method=JVGGish.forward_feat))(jvars, frames)
    np.testing.assert_allclose(pv.forward_feat(torch.from_numpy(frames)).numpy(),
                               np.asarray(ref), atol=ATOL, rtol=0)


# keys JAX's converters index (a KeyError there), by sub-network, and one
# whose presence JAX tests first (a block's proj: its bias is then indexed)
MISSING = ["module.visual_net.blocks.4.attn.rel_pos_w", "module.visual_net.cls_token",
           "module.visual_net.blocks.1.proj.bias", "module.audio_net.features.13.bias",
           "module.spatiotemp_net.transformer.norm.weight",
           "module.decoder_net.invpt_decoder.mt_proj.1.running_var",
           "module.decoder_net.invpt_decoder.mid_stages.2.patch_embed.0.proj.5.running_mean",
           "module.decoder_net.invpt_decoder.mid_stages.3.blocks.0.attn.conv_proj_q.conv.weight"]


@pytest.mark.parametrize("key", MISSING)
def test_a_missing_key_raises_naming_it(full, key):
    src = convert.load_torch_state_dict(full["path"])
    del src[key]
    with pytest.raises(KeyError, match=key[len("module."):].replace(".", r"\.")):
        convert.convert_full(src, full["cfg"].visual.num_layers)
    with pytest.raises(KeyError):
        jconvert.convert_video_saliency_model(src, full["cfg"].visual.num_layers)


def test_presence_tested_parts_are_optional_as_in_jax(full):
    """A block without `proj`, a missing stage norm, `align_conv` and
    `nin_shortcut`: JAX reads around them, and so does the port (the
    import then lacks exactly those entries)."""
    src = convert.load_torch_state_dict(full["path"])
    gone = [k for k in src if any(s in k for s in (
        "visual_net.blocks.1.proj.", "visual_net.norm3.", "res_encoder.1.0.nin_shortcut.",
        "mid_stages.1.blocks.0.align_conv."))]
    assert len(gone) == 8
    sd, _ = convert.convert_full({k: v for k, v in src.items() if k not in gone},
                                 full["cfg"].visual.num_layers)
    full_sd, _ = convert.convert_full(src, full["cfg"].visual.num_layers)
    assert set(full_sd) - set(sd) == {k[len("module."):] for k in gone}


def test_entry_point_writes_a_directory_the_readers_take(full, tmp_path, capsys):
    """The import script's directory: `0.pth` with the reference's keys and
    `best.json` pointing at it, read by the CLI's `_best_state_dict` and by
    `Trainer.restore_best` (full), and by the warm start (mvit): the
    visual_net from the file, the decoder's BatchNorm statistics the
    initial ones (F8)."""
    from diff_sal_tpu_torch import cli
    from diff_sal_tpu_torch.train.checkpoint import CheckpointManager
    from diff_sal_tpu_torch.train.trainer import Trainer

    cfg = full["cfg"]
    L = cfg.visual.num_layers
    work = tmp_path / "run"
    out = str(work / "weights")
    report = import_reference_ckpt.import_checkpoint(full["path"], out, num_mvit_layers=L)
    printed = capsys.readouterr().out
    assert f"loaded {report.loaded} tensors" in printed and "step_counter" in printed
    mgr = CheckpointManager(out)
    assert mgr.all_steps() == [0] and mgr.best()["step"] == 0
    saved = mgr.restore(0)
    assert sorted(saved) == ["epoch", "optim_dict", "state_dict", "step"]
    assert (saved["optim_dict"], saved["epoch"], saved["step"]) == (None, 0, 0)
    want, _ = convert.convert_full(convert.load_torch_state_dict(full["path"]),
                                   cfg.visual.num_layers)
    got = cli._best_state_dict(out, torch.device("cpu"))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(FileExistsError):
        import_reference_ckpt.import_checkpoint(full["path"], out, num_mvit_layers=L)

    t = Trainer(pc.ExperimentConfig(model=pc.from_fields(cfg)), str(work), 1, device="cpu")
    t.init_state()
    t.restore_best()
    sd = t.model.state_dict()
    assert all(torch.equal(sd[k], want[k].reshape(sd[k].shape)) for k in want)

    # a Kinetics MViT into the warm start
    mvit_path = str(tmp_path / "kinetics.pth")
    visual = {k[len("visual_net."):]: v for k, v in want.items() if k.startswith("visual_net.")}
    torch.save({"state_dict": {**{f"backbone.{k}": v for k, v in visual.items()},
                               "cls_head.fc_cls.weight": torch.randn(400, 768)}}, mvit_path)
    import_reference_ckpt.import_checkpoint(mvit_path, str(tmp_path / "mvit"), "mvit",
                                            num_mvit_layers=L)
    av = Trainer(pc.ExperimentConfig(model=pc.from_fields(cfg)), str(tmp_path / "av"), 1,
                 device="cpu")
    av.init_state(seed=3)
    initial = {k: v.clone() for k, v in av.model.state_dict().items()}
    av.warm_start(cli._best_state_dict(str(tmp_path / "mvit"), torch.device("cpu")))
    sd = av.model.state_dict()
    for k, v in sd.items():
        if k.startswith("visual_net."):
            assert torch.equal(v, visual[k[len("visual_net."):]]), k
        else:
            assert torch.equal(v, initial[k]), k


def test_quantised_model_takes_the_import_through_quantize_state_dict(full):
    """A model with `mlp_quant` takes the import as it takes any fp
    state_dict, through `ops/quant.quantize_state_dict`: the result loads
    strictly and the quantised model runs on it."""
    from diff_sal_tpu_torch.ops.quant import quantize_state_dict

    cfg = full["cfg"]
    sd, _ = convert.convert_full(convert.load_torch_state_dict(full["path"]),
                                 cfg.visual.num_layers)
    qcfg = pc.from_fields(cfg)
    qcfg = dataclasses.replace(qcfg, visual=dataclasses.replace(qcfg.visual, mlp_quant="w8"))
    qm = VideoSaliencyModel(qcfg).eval()
    qsd = quantize_state_dict(sd, qm.state_dict())
    assert any(k.endswith(".weight_q") for k in qsd)
    qm.load_state_dict(qsd, strict=True)
    fp = VideoSaliencyModel(pc.from_fields(cfg)).eval()
    fp.load_state_dict(sd, strict=True)
    rgb, audio, x, t = map(torch.from_numpy, _inputs(cfg, 70))
    with torch.no_grad():
        q_out = qm({"rgb": rgb, "input": x, "audio": audio}, t)
        fp_out = fp({"rgb": rgb, "input": x, "audio": audio}, t)
    assert bool(torch.isfinite(q_out).all()) and not torch.equal(q_out, fp_out)
    with pytest.raises(ValueError):
        convert.convert_checkpoint(sd, "resnet")


def test_entry_point_takes_ckpt_out_dir_and_kind(monkeypatch):
    """The command line has JAX's arguments only: ckpt, out_dir and
    `--kind`; the depth is MViTv2-S's 16 blocks."""
    seen = {}
    monkeypatch.setattr(import_reference_ckpt, "import_checkpoint",
                        lambda *a, **k: seen.setdefault("call", (a, k)))
    import_reference_ckpt.main(["a.pth", "out", "--kind", "vggish"])
    assert seen["call"] == (("a.pth", "out", "vggish"), {})
    with pytest.raises(SystemExit):
        import_reference_ckpt.main(["a.pth", "out", "--num_mvit_layers", "2"])
