"""Where the sampler's card time goes (B=8, S=5, V=50257).

Run from the root of a checkout on a CUDA card:
``python3 scripts/port_probe_sampler.py``. Times one
``speculative_sample_tokens`` with its key data on the card and its
pieces (random bits, Gumbel, sort, softmax and cumsum) with CUDA events,
its host enqueue time, and a ``torch.profiler`` breakdown by kernel.
"""
import json, sys, time
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from stoke_tpu_torch.serving import sampling as S
from torch.profiler import ProfilerActivity, profile
from torch.autograd import DeviceType

dev = "cuda"
flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
kd = S.key_data_to_device(np.stack([S.initial_key_data(i) for i in range(8)]), dev)
logits = torch.randn(8, 5, 50257, device=dev) * 3
kn = (torch.full((8,), 0.8, device=dev), torch.full((8,), 50, dtype=torch.int32, device=dev), torch.full((8,), 0.95, device=dev))
_, subs = S.split_key_data(kd)
subs = subs[None].expand(5, 8, 2).contiguous()
res = {}
res["spec_sample_ms"] = cs.time_ms(lambda: S.speculative_sample_tokens(logits, kd, *kn), 20, flush)
res["random_bits_ms"] = cs.time_ms(lambda: S.random_bits(subs, 50257), 20, flush)
res["gumbel_ms"] = cs.time_ms(lambda: S.gumbel(subs, 50257), 20, flush)
lt = logits.transpose(0, 1).contiguous()
res["sort_ms"] = cs.time_ms(lambda: torch.sort(lt, dim=-1, descending=True), 20, flush)
res["softmax_cumsum_ms"] = cs.time_ms(lambda: torch.cumsum(torch.softmax(lt, -1), -1), 20, flush)
# host enqueue time of one call
torch.cuda.synchronize(); t0 = time.perf_counter()
for _ in range(10): S.speculative_sample_tokens(logits, kd, *kn)
t1 = time.perf_counter(); torch.cuda.synchronize(); t2 = time.perf_counter()
res["host_enqueue_ms"] = (t1 - t0) / 10 * 1e3; res["wall_ms"] = (t2 - t0) / 10 * 1e3
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    S.speculative_sample_tokens(logits, kd, *kn); torch.cuda.synchronize()
rows = sorted(((getattr(e, "self_device_time_total", 0.0) / 1e3, e.key, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA), reverse=True)
res["device_ms_total"] = sum(r[0] for r in rows)
res["n_kernels"] = sum(r[2] for r in rows)
res["top"] = [(round(a, 4), b[:70], c) for a, b, c in rows[:12]]
print(json.dumps(res, indent=0))
print(cs.nvidia_smi_line())
