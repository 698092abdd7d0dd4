"""Probe of ``chip_smoke.py``'s BERT phase on a CUDA card.

Run from the root of a checkout:
``python3 scripts/port_probe_bert.py [--sweep]``.
Builds ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and runs
``chip_smoke.train_bert`` (the flash kernels at BERT-base's attention
shapes, 40 four-call micro-steps of BERT-base from a document on bucketed
ragged batches, the fp32 flash-against-dense run), printing its line. With
``--sweep`` it runs, instead, the phase's training loop alone for each
learning rate of 3e-4, 1e-4 and 3e-5 and each initialization (BERT's
N(0, 0.02), flax's defaults) and prints each run's losses: what the
phase's learning rate and initialization were chosen from. Exits nonzero
if the phase fails.
"""
import argparse
import json
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from stoke_tpu_torch import ops  # noqa: E402
from stoke_tpu_torch.ops import _build  # noqa: E402


def sweep() -> None:
    from stoke_tpu_torch.data import (
        BucketedDistributedSampler,
        RaggedSequenceDataset,
    )
    from stoke_tpu_torch.utils.yaml_config import stoke_from_config

    seqs, labels = cs.bert_corpus()
    ds = RaggedSequenceDataset(seqs, labels, pad_multiple=cs.BERT_PAD)
    sampler = BucketedDistributedSampler(
        ds, buckets=cs.BERT_BUCKETS, batch_size=cs.BERT_BATCH,
        sorted_idx=ds.sorted_idx(), num_replicas=1, rank=0, seed=cs.SEED,
        info_rank=-1)
    for lr in (3e-4, 1e-4, 3e-5):
        for init in ("bert", "flax"):
            doc = {**cs.BERT_DOC,
                   "optimizer": {"name": "adamw", "learning_rate": lr}}
            stoke = stoke_from_config(cs.bert_base("flash", init=init),
                                      cs.bert_loss, None, doc)
            losses = []
            for i, (batch, y) in enumerate(stoke.DataLoader(
                    ds, sampler=sampler)):
                if i == cs.BERT_MICRO:
                    break
                losses.append(cs.bert_micro_step(stoke, batch, y))
            print(json.dumps({
                "lr": lr, "init": init,
                "first5_mean": float(np.mean(losses[:5])),
                "last5_mean": float(np.mean(losses[-5:])),
                "losses": losses}), flush=True)
            del stoke
            torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", action="store_true",
                        help="the training loop at three learning rates "
                             "and two initializations instead")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    print(json.dumps({"build": _build.build(["flash_fwd", "flash_bwd"])}),
          flush=True)
    if args.sweep:
        sweep()
    else:
        print(json.dumps(cs.train_bert(ops)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
