"""Probe of the paged-verify kernel and the sampler on a CUDA card.

Run from the root of a checkout: ``python3 scripts/port_probe_verify.py``.
Builds the port's kernels, holds the verify kernel against its plain
version at the speculative serve shapes (``chip_smoke.check_verify``) and
at D=128 and S up to 16, checks that the sampler's threefry bits, Gumbel
values, targets and key stack on the card equal the CPU's, and times the
sampler (``chip_smoke.sampler_ms``).
"""
import json, sys, time
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from stoke_tpu_torch import ops
from stoke_tpu_torch.ops import _build
from stoke_tpu_torch.serving import sampling as S

t0 = time.time()
print(json.dumps({"build": _build.build(), "s": time.time() - t0}), flush=True)
print(json.dumps({n: [l.strip()[:160] for l in (_build.build_log(n) or "").splitlines()
                      if "Function properties" in l or "registers" in l or "spill" in l]
                  for n in ["paged_verify"]}), flush=True)
gen = torch.Generator(device="cuda").manual_seed(0)
flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
print(json.dumps(cs.check_verify(ops, gen, flush)), flush=True)
# D=128 and S=16 instantiations, bf16 queries
for D, Sq, qdt in ((128, 5, torch.float32), (64, 16, torch.bfloat16), (128, 12, torch.bfloat16)):
    B, H, BS, MB = 3, 4, 16, 8
    NB = B * MB + 1
    q = torch.randn(B, H, Sq, D, device="cuda").to(qdt)
    kp = torch.randn(NB, BS, H, D, device="cuda")
    vp = torch.randn(NB, BS, H, D, device="cuda")
    tables = torch.arange(1, NB, dtype=torch.int32, device="cuda").view(B, MB)
    pos = torch.stack([torch.arange(Sq) + c for c in (0, 40, 100)]).to(torch.int32).cuda()
    out = ops.paged_verify_attention_pallas(q, kp, vp, tables, pos)
    ref = ops.paged_verify_attention(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    print(json.dumps({"D": D, "S": Sq, "q": str(qdt), "err": cs.max_err(out, ref)}), flush=True)
# sampler bits on the card equal the CPU's
kd = np.stack([S.initial_key_data(i) for i in range(8)])
c_cpu, s_cpu = S.split_key_data(S.key_data_to_device(kd))
c_gpu, s_gpu = S.split_key_data(S.key_data_to_device(kd, "cuda"))
bits_eq = torch.equal(S.random_bits(s_cpu, 50257), S.random_bits(s_gpu, 50257).cpu())
g_err = float((S.gumbel(s_cpu, 50257) - S.gumbel(s_gpu, 50257).cpu()).abs().max())
logits = torch.randn(8, 5, 50257) * 3
kn = (torch.full((8,), 0.8), torch.full((8,), 50, dtype=torch.int32), torch.full((8,), 0.95))
t_cpu, st_cpu = S.speculative_sample_tokens(logits, S.key_data_to_device(kd), *kn)
t_gpu, st_gpu = S.speculative_sample_tokens(logits.cuda(), S.key_data_to_device(kd, "cuda"), *(x.cuda() for x in kn))
print(json.dumps({"bits_equal": bits_eq, "gumbel_max_diff": g_err,
                  "targets_equal": torch.equal(t_cpu, t_gpu.cpu()), "keys_equal": torch.equal(st_cpu, st_gpu.cpu()),
                  "sampler_ms": cs.sampler_ms(flush), "launches": ops.LAUNCHES}), flush=True)
print(cs.nvidia_smi_line())
