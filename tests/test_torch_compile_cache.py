"""The port's compile cache (``stoke_tpu_torch/compile_cache.py``) against
the JAX package's (``stoke_tpu/compile_cache.py``): the kernel libraries'
names (the repaired build key, ``ops/_build.py``), the ledger's hits and
misses over the libraries a process loads, the failure policy, the status
rules and YAML build, the ``stats()`` keys and the goodput ledger's cached
share.

GPT-tiny on the CPU, one torch thread (the file's runs are tiny and would
spin against the other workers)."""

import json
import os
import shutil
import subprocess
import sys
import warnings

import pytest
import torch

import stoke_tpu.configs as jc
from stoke_tpu.compile_cache import CompileCache as JaxCompileCache
from stoke_tpu.status import StokeStatus as JaxStatus
from stoke_tpu.utils.yaml_config import (
    stoke_kwargs_from_config as jax_kwargs_from_config,
)
from stoke_tpu_torch import Stoke, StokeOptimizer, StokeValidationError
from stoke_tpu_torch import configs as pc
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.ops import _build
from stoke_tpu_torch.ops.flash_attention import make_flash_attention
from stoke_tpu_torch.status import StokeStatus
from stoke_tpu_torch.utils.yaml_config import stoke_kwargs_from_config

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gpt():
    m = GPT(vocab_size=257, size_name="tiny", max_len=64, dropout_rate=0.0,
            attention_fn=make_flash_attention(causal=True),
            attention_is_causal=True)
    m.init_weights(0)
    return m


def _stoke(cache_dir=None, configs=(), **kw):
    cfgs = list(configs)
    if cache_dir is not None:
        cfgs.append(pc.CompileConfig(cache_dir=str(cache_dir)))
    with warnings.catch_warnings():
        # the CPU refuses the persistent kernel directory (nothing builds)
        warnings.filterwarnings("ignore", ".*persistent kernel cache")
        return Stoke(_gpt(), StokeOptimizer(torch.optim.AdamW, lr=3e-3),
                     causal_lm_loss, batch_size_per_device=2, device="cpu",
                     configs=cfgs, verbose=False, **kw)


def _batch():
    g = torch.Generator().manual_seed(0)
    return torch.randint(0, 257, (2, 16), generator=g)


# --------------------------------------------------------------------------- #
# the build key
# --------------------------------------------------------------------------- #


def _edit_flags(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))


def _edit_source(monkeypatch, tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    header = sorted(copy.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC", copy)


@pytest.mark.parametrize("component", ["release", "flags", "source"])
def test_each_toolchain_component_names_another_library(
        component, monkeypatch, tmp_path):
    """The build key (``ops/_build.py``): a library is named by its
    sources, the flags and the ``nvcc --version`` release line, so a
    library built by another nvcc, under other flags or from another
    source is never loaded as the current one; the same three name the
    same library."""
    release = "Cuda compilation tools, release 12.8, V12.8.93"
    a = _build.library_path("paged_decode", release=release)
    assert a == _build.library_path("paged_decode", release=release)
    if component == "release":
        b = _build.library_path("paged_decode",
                                release=release.replace("12.8", "12.9"))
    else:
        {"flags": _edit_flags, "source": _edit_source}[component](
            monkeypatch, tmp_path)
        b = _build.library_path("paged_decode", release=release)
    assert b != a and b.parent == a.parent


def test_library_names_are_the_same_in_a_subprocess():
    """A fresh process names every library as this one does: the name
    holds no pointer, id or process counter."""
    code = ("import json, sys; sys.path.insert(0, {repo!r}); "
            "from stoke_tpu_torch.ops import _build; print(json.dumps("
            "[_build.library_path(n, release='r').name "
            "for n in _build.SOURCES]))").format(repo=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        _build.library_path(n, release="r").name for n in _build.SOURCES]


# --------------------------------------------------------------------------- #
# the ledger: the libraries a process loads
# --------------------------------------------------------------------------- #


@pytest.fixture
def loads(monkeypatch):
    """This test's own record of loaded libraries and listeners."""
    monkeypatch.setattr(_build, "_loads", [])
    monkeypatch.setattr(_build, "_listeners", [])


def _library(cache_dir, name, share_s=None, record=None):
    """A library file in ``<cache_dir>/kernels`` with its build record
    (``record`` written as it is where given)."""
    path = cache_dir / "kernels" / f"lib{name}-0123456789abcdef.so"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"")
    if record is not None:
        path.with_suffix(".json").write_text(record)
    elif share_s is not None:
        _build._write_record(path, {"build_s": 2 * share_s,
                                    "share_s": share_s})
    return path


def _load(name, path, built, load_s=0.01):
    _build._note_load(_build.LoadRecord(name, path, built, load_s))


def test_a_built_library_is_a_miss_and_a_loaded_one_a_hit(tmp_path, loads):
    """The JAX ledger's accounting over the libraries: one this process
    built is a miss; one it found in the directory is a hit that credits
    the cold build's recorded seconds and books its load's seconds."""
    cc_dir = tmp_path / "cc"
    s = _stoke(cc_dir)
    _load("flash_fwd", _library(cc_dir, "flash_fwd"), built=True)
    _load("quant", _library(cc_dir, "quant", share_s=2.5), built=False,
          load_s=0.25)
    # a library loaded from elsewhere is none of the cache's
    _load("paged_decode", tmp_path / "libpaged_decode-x.so", built=False)
    st = s.compile_cache.stats()
    assert (st["misses"], st["hits"], st["entries"]) == (1, 1, 2)
    assert st["saved_compile_s"] == pytest.approx(2.5)
    reg = s._telemetry.registry
    assert reg.get("compile_cache/hit_s_total").value == pytest.approx(0.25)
    assert reg.get("compile_cache/saved_s_total").value == pytest.approx(2.5)


def test_a_second_stoke_books_the_process_libraries_as_hits(tmp_path, loads):
    """Layer 1: a second run in the process uses the libraries the first
    loaded, builds nothing, and credits their build records, with no load
    of its own to book."""
    cc_dir = tmp_path / "cc"
    first = _stoke(cc_dir)
    _load("flash_fwd", _library(cc_dir, "flash_fwd", share_s=4.0),
          built=True)
    _load("flash_bwd", _library(cc_dir, "flash_bwd", share_s=4.0),
          built=False)
    second = _stoke(cc_dir)
    st = second.compile_cache.stats()
    assert (st["hits"], st["misses"]) == (2, 0)
    assert st["saved_compile_s"] == pytest.approx(8.0)
    assert second._telemetry.registry.get(
        "compile_cache/hit_s_total").value == 0
    assert first.compile_cache.stats()["misses"] == 1


def test_corrupt_record_is_an_error_not_a_crash(tmp_path, loads):
    """An unreadable build record: the hit stands (the library served),
    nothing is credited, one warning and a ``serialize_errors`` count."""
    cc_dir = tmp_path / "cc"
    s = _stoke(cc_dir)
    with pytest.warns(UserWarning, match="compile cache read failed"):
        _load("quant", _library(cc_dir, "quant", record="{not json"),
              built=False)
    st = s.compile_cache.stats()
    assert (st["hits"], st["serialize_errors"]) == (1, 1)
    assert st["saved_compile_s"] == 0


def test_cache_off_is_bit_for_bit_the_same(tmp_path):
    """With and without a CompileConfig: the same losses, parameters and
    dispatch count, over the fused step, the four calls and a window."""
    torch.manual_seed(0)
    x = _batch()
    runs = []
    for cache in (None, tmp_path / "cc"):
        s = _stoke(cache, grad_accum=2)
        losses = [s.train_step_window(torch.stack([x, x]),
                                      torch.stack([x, x]))]
        out = s.model(x)
        losses.append(s.loss(out, x))
        s.backward(losses[-1])
        s.step()
        runs.append((losses, {n: p.detach().clone()
                              for n, p in s.model_access.named_parameters()},
                     s.dispatch_count))
    (l0, p0, d0), (l1, p1, d1) = runs
    assert d0 == d1
    for a, b in zip(l0, l1):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


# --------------------------------------------------------------------------- #
# status, YAML, stats, goodput
# --------------------------------------------------------------------------- #


def _blocked(tmp_path):
    f = tmp_path / "blocker"
    f.write_text("x")
    return str(f / "sub")


@pytest.mark.parametrize("case", ["negative_min", "nothing", "unwritable",
                                  "accepted"])
def test_status_rules_match_jax(case, tmp_path):
    """The JAX legality rules of a CompileConfig, letter for letter; a
    legal one is accepted (no longer refused as a later slice)."""
    fields = {"negative_min": dict(min_compile_time_s=-1.0),
              "nothing": dict(aot=False, xla_cache=False),
              "unwritable": dict(cache_dir=_blocked(tmp_path)),
              "accepted": dict(cache_dir=str(tmp_path / "ok"))}[case]
    fields.setdefault("cache_dir", str(tmp_path / "ok"))
    kw = dict(batch_size_per_device=2)
    try:
        JaxStatus(configs=[jc.CompileConfig(**fields)], **kw)
        jax_msg = None
    except Exception as e:
        jax_msg = str(e)
    if jax_msg is None:
        st = StokeStatus(configs=[pc.CompileConfig(**fields)], device="cpu",
                         **kw)
        assert st.compile_config == pc.CompileConfig(**fields)
        assert case == "accepted"
        return
    with pytest.raises(StokeValidationError) as e:
        StokeStatus(configs=[pc.CompileConfig(**fields)], device="cpu", **kw)
    assert str(e.value) == jax_msg


def test_yaml_build_matches_jax(tmp_path):
    """A document's CompileConfig builds the same config in both packages,
    and the port's document builds the run."""
    doc = {"batch_size_per_device": 2,
           "configs": {"CompileConfig": {
               "cache_dir": str(tmp_path / "cc"), "aot": True,
               "xla_cache": False, "min_compile_time_s": 0.5}}}
    ours = stoke_kwargs_from_config(dict(doc))
    theirs = jax_kwargs_from_config(dict(doc))
    (o,), (t,) = ours["configs"], theirs["configs"]
    assert type(o).__name__ == type(t).__name__ == "CompileConfig"
    assert vars(o) == vars(t)
    s = _stoke(configs=ours["configs"])
    assert s.compile_cache is not None
    assert s.compile_cache.stats()["cache_dir"] == str(tmp_path / "cc")


def test_stats_have_the_jax_keys(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = JaxCompileCache(jc.CompileConfig(
            cache_dir=str(tmp_path / "jax"), xla_cache=False)).stats()
    s = _stoke(tmp_path / "cc")
    ours = s.compile_cache.stats()
    assert set(ours) == set(theirs)
    # no card: the persistent kernel directory is refused, as the JAX
    # cache refuses the CPU backend
    assert ours["xla_cache_active"] is False


def test_goodput_cached_share_after_a_hit(tmp_path, loads):
    """The goodput ledger's cached compile share is the hits' load
    seconds (``compile_cache/hit_s_total``), no longer a fixed 0."""
    x = _batch()
    cc_dir = tmp_path / "cc"
    s = _stoke(cc_dir, configs=[
        pc.TelemetryConfig(output_dir=str(tmp_path / "tel"),
                           log_every_n_steps=1, prometheus=False),
        pc.AttributionConfig(peak_tflops=1.0)])
    s.train_step(x, x)
    reg = s._telemetry.registry
    assert reg.get("goodput/compile_cached_s_total").value == 0
    _load("quant", _library(cc_dir, "quant", share_s=2.0), built=False,
          load_s=0.5)
    s.train_step(x, x)
    assert reg.get("compile_cache/hit_s_total").value == pytest.approx(0.5)
    assert reg.get("goodput/compile_cached_s_total").value > 0
    s.close_telemetry()
