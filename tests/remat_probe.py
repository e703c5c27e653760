"""What `MViTConfig.remat` buys and costs on the card, beside phase 15 of
chip_smoke.py (a script, not collected by pytest; run from the
repository's root on a machine with the card):

    python3 tests/remat_probe.py

The AV bf16 step at B=4 with remat off, on, off and on again from seed-0
weights, the same batch and draws (loss, peak memory, ms per step by CUDA
events, and the gradients of each pair: the card's run-to-run spread beside
remat's), then the AV f32 step at B=4 and B=8 with and without remat (loss,
peak, ms per step, or that it ran out of memory).
"""
import gc
import json
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from diff_sal_tpu_torch.config import ModelConfig  # noqa: E402
from diff_sal_tpu_torch.diffusion.schedule import make_schedule  # noqa: E402
from diff_sal_tpu_torch.ops import kernels  # noqa: E402

smi = cs.nvidia_smi_line()
print(torch.cuda.get_device_name(0), "|", smi, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
kernels.build_all()
print("[build]", time.perf_counter() - t0, flush=True)
dev = torch.device("cuda")
schedule = make_schedule()


# bf16 control: remat off twice, on twice
bf = cs.main_config()
batch = cs.train_batch(4, bf, 15, dev)
grads = {}
for name, remat in (("off", False), ("on", True), ("off2", False), ("on2", True)):
    loss, counts, g, ms, peak, _ = cs.remat_steps(dev, schedule, cs.with_remat(bf, remat), batch, 3,
                                               f"bf16 {name}")
    grads[name] = g
    print(f"[explore] bf16 B=4 remat {name}: loss {loss:.6f} peak {peak:.2f} GiB ms "
          + ", ".join(f"{t:.2f}" for t in ms), flush=True)
    gc.collect()
for a, b in (("off2", "off"), ("on2", "on"), ("on", "off"), ("on2", "off2")):
    stats, worst = cs.grad_agreement(grads[a], grads[b])
    print(f"[explore] grads {a} vs {b}: " + json.dumps(stats) + f" worst {worst}", flush=True)
del grads
gc.collect()

f32 = ModelConfig.audio_visual()
for b, remat in ((4, False), (4, True), (8, True), (8, False)):
    gc.collect()
    torch.cuda.empty_cache()
    try:
        loss, counts, _, ms, peak, _ = cs.remat_steps(dev, schedule, cs.with_remat(f32, remat),
                                                   cs.train_batch(b, f32, 18, dev), 2,
                                                   f"f32 B={b} remat={remat}")
    except torch.cuda.OutOfMemoryError as e:
        print(f"[explore] f32 B={b} remat={remat}: out of memory: {str(e)[:300]}", flush=True)
        continue
    print(f"[explore] f32 B={b} remat={remat}: loss {loss:.4f} peak {peak:.2f} GiB ms "
          + ", ".join(f"{t:.2f}" for t in ms), flush=True)
print("[explore] done", flush=True)
