"""Port parity: the TensorBoard event writer and ``TensorboardConfig``.

The cases of ``tests/test_utils.py`` against the port's copy of the
writer; its frames are byte-equal to the JAX writer's for the same
scalars, apart from the wall time. ``Stoke`` with a ``TensorboardConfig``
writes the JAX facade's loss metrics every ``log_every_n_steps`` optimizer
steps (on every step path) and ``log_scalar``'s user scalars.
"""

import struct

import numpy as np
import pytest
import torch

from stoke_tpu.utils import tb_writer as jax_tb
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch.configs import PrecisionConfig, TensorboardConfig
from stoke_tpu_torch.utils.tb_writer import TBEventWriter, read_scalar_events
from stoke_tpu_torch.utils import tb_writer

pytestmark = pytest.mark.torch_port


def test_format_round_trip(tmp_path):
    w = TBEventWriter(str(tmp_path))
    w.add_scalar("loss", 0.75, 3)
    w.add_scalar("acc", 0.5, 4)
    w.close()
    events = read_scalar_events(w.path)
    assert ("loss", 0.75, 3) in events and ("acc", 0.5, 4) in events
    assert jax_tb.read_scalar_events(w.path) == events


def test_detects_corruption(tmp_path):
    w = TBEventWriter(str(tmp_path))
    w.add_scalar("x", 1.0, 1)
    w.close()
    data = bytearray(open(w.path, "rb").read())
    data[-3] ^= 0xFF
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        read_scalar_events(w.path)


def test_negative_step(tmp_path):
    w = TBEventWriter(str(tmp_path))
    w.add_scalar("x", 2.5, -1)
    w.close()
    (tag, val, step) = read_scalar_events(w.path)[0]
    assert tag == "x" and val == 2.5
    assert step == (1 << 64) - 1


@pytest.mark.parametrize("tag,value,step", [
    ("loss/ema", 0.1234, 7), ("x", -3.5, 0), ("a/b/c", 1e30, 2**40),
    ("neg", 2.0, -5), ("ünïcode", float("inf"), 1)])
def test_frames_equal_the_jax_writers(tag, value, step):
    wall = 1.5e9
    ours = tb_writer._scalar_event(tag, value, step, wall)
    assert ours == jax_tb._scalar_event(tag, value, step, wall)
    assert tb_writer._version_event(wall) == jax_tb._version_event(wall)
    assert tb_writer._masked_crc(ours) == jax_tb._masked_crc(ours)


def test_files_equal_the_jax_writers_but_wall_time(tmp_path):
    paths = []
    for mod in (tb_writer, jax_tb):
        w = mod.TBEventWriter(str(tmp_path / mod.__name__))
        for i in range(5):
            w.add_scalar("loss", 1.0 / (i + 1), i)
        w.close()
        paths.append(w.path)

    def records(path):
        out, data, i = [], open(path, "rb").read(), 0
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i:i + 8])
            payload = data[i + 12:i + 12 + n]
            out.append(payload[9:])  # drop wall_time (key byte + double)
            i += 16 + n
        return out

    assert records(paths[0]) == records(paths[1])
    assert len(records(paths[0])) == 6


def _run(tmp_path, precision=None, steps=6, path="four_call", every=2):
    torch.manual_seed(0)
    cfgs = [TensorboardConfig(output_path=str(tmp_path), job_name="run",
                              log_every_n_steps=every)]
    if precision == "fp16":
        cfgs.append(PrecisionConfig(init_scale=256.0))
    s = Stoke(torch.nn.Linear(3, 1), StokeOptimizer(torch.optim.SGD,
                                                    lr=0.05),
              lambda o, y: ((o - y) ** 2).mean(), batch_size_per_device=4,
              grad_accum=2, device="cpu", precision=precision, configs=cfgs)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 3)).astype(np.float32))
    y = x.sum(1, keepdim=True)
    if path == "four_call":
        for _ in range(2 * steps):
            s.backward(s.loss(s.model(x), y))
            s.step()
    elif path == "train_step":
        for _ in range(2 * steps):
            s.train_step(x, y)
    else:
        s.train_steps(x.expand(2 * steps, 4, 3), y.expand(2 * steps, 4, 1))
    s.log_scalar("user/lr", 0.05)
    s._tb_writer.close()
    files = list((tmp_path / "run").glob("events.out.tfevents.*"))
    assert len(files) == 1
    return s, read_scalar_events(str(files[0]))


@pytest.mark.parametrize("path", ["four_call", "train_step", "train_steps"])
def test_stoke_logs_the_loss_metrics_at_the_cadence(tmp_path, path):
    s, events = _run(tmp_path, path=path)
    by_tag = {}
    for tag, v, step in events:
        by_tag.setdefault(tag, []).append((step, v))
    if path == "train_steps":  # one segment: logged once, at its end
        steps = [6]
    else:
        steps = [2, 4, 6]
    assert [st for st, _ in by_tag["loss/ema"]] == steps
    assert [st for st, _ in by_tag["loss/micro"]] == steps
    assert by_tag["counters/backward_steps"][-1] == (6, 12.0)
    assert by_tag["user/lr"] == [(6, pytest.approx(0.05))]
    assert by_tag["loss/ema"][-1][1] == pytest.approx(s.ema_loss, rel=1e-6)
    assert "scaler/loss_scale" not in by_tag


def test_fp16_logs_the_scaler(tmp_path):
    _, events = _run(tmp_path, precision="fp16", steps=2)
    tags = {t for t, _, _ in events}
    assert {"scaler/loss_scale", "scaler/skipped_steps"} <= tags
    assert ("scaler/loss_scale", 256.0, 2) in events


def test_no_config_no_writer(tmp_path):
    s = Stoke(torch.nn.Linear(2, 1), StokeOptimizer(torch.optim.SGD, lr=0.1),
              lambda o, y: o.sum(), batch_size_per_device=2, device="cpu")
    assert s._tb_writer is None
    s.log_scalar("x", 1.0)  # a no-op without a TensorboardConfig
