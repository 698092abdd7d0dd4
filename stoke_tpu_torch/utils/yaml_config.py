"""A YAML document or dict -> the port's ``Stoke``.

The port's copy of ``stoke_tpu/utils/yaml_config.py``, with the same
schema and errors, so one document describes one run in both packages:

    batch_size_per_device: 32
    grad_accum: 2
    device: cuda
    precision: bf16
    grad_clip: {type: norm, max_norm: 1.0}   # or {type: value, clip_value: 0.5}
    optimizer: {name: adamw, learning_rate: 3.0e-4}
    seed: 0
    configs:                                     # config objects by class name
      TensorboardConfig: {output_path: runs, log_every_n_steps: 5}
      CheckpointConfig: {save_every_n_steps: 500, auto_path: ckpts/auto}

The ``optimizer`` section names an optax constructor and its arguments;
the port builds the ``torch.optim`` optimizer that computes the same
(:func:`stoke_tpu_torch.convert.torch_optimizer_from_optax`: ``adamw``,
``adam`` and ``sgd``, with optax's defaults). Config classes come from
``ALL_CONFIG_CLASSES`` (``TelemetryConfig``, ``TraceConfig``,
``HealthConfig`` and ``ProfilerConfig`` among the honoured ones);
``StokeStatus`` then refuses those of later slices with the ROADMAP item. YAML lists become tuples, and the enum fields
(``format``, ``loss_reduction``) their enums. PyYAML is imported only to
read a path.

:func:`stoke_from_example` builds a run from the CIFAR-10 example's own
documents (``examples/cifar10/config/*.yaml``), which use that example's
schema.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

from stoke_tpu_torch.configs import (
    ALL_CONFIG_CLASSES,
    CheckpointFormat,
    ClipGradConfig,
    ClipGradNormConfig,
    LossReduction,
    StokeOptimizer,
)
from stoke_tpu_torch.convert import torch_optimizer_from_optax

_CONFIG_BY_NAME = {cls.__name__: cls for cls in ALL_CONFIG_CLASSES}
# enum-valued fields that arrive as strings from YAML
_ENUM_FIELDS = {"format": CheckpointFormat, "loss_reduction": LossReduction}

_STOKE_FLAG_KEYS = (
    "batch_size_per_device", "grad_accum", "device", "distributed",
    "precision", "oss", "sddp", "fsdp", "seed", "ema_weight", "verbose",
    "model_train_kwargs", "model_eval_kwargs", "model_rng_keys",
)


def _build_grad_clip(spec: Optional[Dict[str, Any]]):
    if spec is None:
        return None
    spec = dict(spec)
    kind = spec.pop("type", "norm")
    if kind in ("norm", "clip_norm"):
        return ClipGradNormConfig(**spec)
    if kind in ("value", "clip_value"):
        return ClipGradConfig(**spec)
    raise ValueError(f"Stoke -- unknown grad_clip type {kind!r}")


def _build_optimizer(spec: Optional[Dict[str, Any]]):
    if spec is None:
        return None
    spec = dict(spec)
    cls, kwargs = torch_optimizer_from_optax(spec.pop("name"), spec)
    return StokeOptimizer(cls, kwargs)


def _build_config_object(name: str, fields: Dict[str, Any]):
    cls = _CONFIG_BY_NAME.get(name)
    if cls is None:
        raise ValueError(
            f"Stoke -- unknown config class {name!r}; valid: "
            f"{sorted(_CONFIG_BY_NAME)}"
        )
    fields = dict(fields or {})
    for key, enum_cls in _ENUM_FIELDS.items():
        if key in fields and isinstance(fields[key], str):
            fields[key] = enum_cls(fields[key])
    # YAML lists -> tuples for tuple-typed fields (axes, shape, rules, ...)
    for k, v in fields.items():
        if isinstance(v, list):
            fields[k] = tuple(tuple(i) if isinstance(i, list) else i
                              for i in v)
    return cls(**fields)


def stoke_kwargs_from_config(
        cfg: Union[str, Dict[str, Any]]) -> Dict[str, Any]:
    """A YAML path or dict as ``Stoke(**kwargs)`` keyword arguments
    (everything but the model, loss and params). Unknown top-level keys
    raise: a typo must not silently train a different run."""
    if isinstance(cfg, str):
        import yaml

        with open(cfg) as f:
            cfg = yaml.safe_load(f)
    cfg = dict(cfg or {})
    out: Dict[str, Any] = {}
    for key in _STOKE_FLAG_KEYS:
        if key in cfg:
            out[key] = cfg.pop(key)
    if "grad_clip" in cfg:
        out["grad_clip"] = _build_grad_clip(cfg.pop("grad_clip"))
    if "optimizer" in cfg:
        out["optimizer"] = _build_optimizer(cfg.pop("optimizer"))
    if "configs" in cfg:
        out["configs"] = [
            _build_config_object(name, fields)
            for name, fields in (cfg.pop("configs") or {}).items()
        ]
    if cfg:
        raise ValueError(f"Stoke -- unknown config keys: {sorted(cfg)}")
    return out


def stoke_from_config(
    model: Any,
    loss: Any,
    params: Any,
    cfg: Union[str, Dict[str, Any]],
    optimizer: Any = None,
    **overrides,
):
    """A :class:`~stoke_tpu_torch.Stoke` from a YAML path or dict.

    ``optimizer`` may come from the document (``optimizer: {name: ...}``)
    or be passed (a ``StokeOptimizer``; the one passed wins).
    ``overrides`` are applied last; ``params`` is a state dict for
    ``model`` or None."""
    from stoke_tpu_torch.facade import Stoke

    kwargs = stoke_kwargs_from_config(cfg)
    if optimizer is not None:
        kwargs["optimizer"] = optimizer
    if "optimizer" not in kwargs:
        raise ValueError(
            "Stoke -- no optimizer: add an `optimizer:` section to the config "
            "or pass one explicitly"
        )
    kwargs.update(overrides)
    return Stoke(model=model, loss=loss, params=params, **kwargs)


#: the keys of the CIFAR-10 example's documents
#: (``examples/cifar10/config/*.yaml``, read by its ``build_stoke``)
_EXAMPLE_KEYS = (
    "model", "device", "distributed", "precision", "grad_accum",
    "grad_clip_norm", "oss", "sddp", "fsdp", "epochs", "batch_size_per_device",
    "lr", "momentum", "seed", "telemetry", "comm", "health",
)


def _example_loss(logits, labels):
    """optax's softmax cross entropy with integer labels, batch mean."""
    import torch.nn.functional as F

    return F.cross_entropy(logits.float(), labels.long())


def stoke_from_example(cfg: Union[str, Dict[str, Any]], model: Any = None,
                       **overrides):
    """A :class:`~stoke_tpu_torch.Stoke` from one of the CIFAR-10
    example's documents (``examples/cifar10/config/*.yaml``, a path or the
    loaded dict), as the example's ``build_stoke`` builds the JAX run:

    - ``model``: ``basic`` (:class:`~stoke_tpu_torch.models.BasicNN`) or
      ``resnet50`` (CIFAR stem, 10 classes); ``model=`` replaces it (for
      instance the same network in ``channels_last`` on the card);
    - ``device``: ``tpu`` (the JAX package's accelerator) is the card,
      ``cpu`` the CPU; a document without it runs on the card, as
      ``Stoke`` does by default;
    - ``distributed``, ``precision``, ``grad_accum``,
      ``batch_size_per_device`` and ``seed`` as flags; ``grad_clip_norm``
      a ``ClipGradNormConfig``;
    - ``oss``, ``sddp``, ``fsdp`` with the example's configs
      (``OSSConfig()``, ``SDDPConfig()``, ``FSDPConfig(min_weight_size=
      2**12)``);
    - ``lr`` and ``momentum`` (0.9): optax's ``sgd``;
    - ``telemetry``, ``comm``, ``health``: their config classes (the
      telemetry pipeline, the gradient transport, the health monitor);
    - ``epochs`` belongs to the training loop and is not read here.

    ``overrides`` replace ``Stoke`` arguments (e.g. ``device="cpu"``).
    Unknown keys raise."""
    from stoke_tpu_torch.configs import (
        CommConfig,
        FSDPConfig,
        HealthConfig,
        OSSConfig,
        SDDPConfig,
        TelemetryConfig,
    )
    from stoke_tpu_torch.facade import Stoke
    from stoke_tpu_torch.models import BasicNN, ResNet50

    if isinstance(cfg, str):
        import yaml

        with open(cfg) as f:
            cfg = yaml.safe_load(f)
    cfg = dict(cfg or {})
    unknown = sorted(set(cfg) - set(_EXAMPLE_KEYS))
    if unknown:
        raise ValueError(f"Stoke -- unknown example config keys: {unknown}")
    if model is None:
        name = cfg.get("model", "basic")
        makers = {"basic": BasicNN,
                    "resnet50": lambda: ResNet50(num_classes=10,
                                                 cifar_stem=True)}
        if name not in makers:
            raise ValueError(f"Stoke -- unknown example model {name!r}; "
                             f"valid: {sorted(makers)}")
        model = makers[name]()
    configs = []
    if cfg.get("fsdp"):
        configs.append(FSDPConfig(min_weight_size=2**12))
    if cfg.get("oss"):
        configs.append(OSSConfig())
    if cfg.get("sddp"):
        configs.append(SDDPConfig())
    for key, cls, short in (("telemetry", TelemetryConfig, None),
                            ("comm", CommConfig, "dtype"),
                            ("health", HealthConfig, None)):
        spec = cfg.get(key)
        if spec:
            configs.append(cls(**spec) if isinstance(spec, dict)
                           else cls(**({short: str(spec)} if short else {})))
    optimizer = StokeOptimizer(*torch_optimizer_from_optax(
        "sgd", {"learning_rate": cfg.get("lr", 0.01),
                "momentum": cfg.get("momentum", 0.9)}))
    kwargs = dict(
        batch_size_per_device=cfg.get("batch_size_per_device", 32),
        grad_accum=cfg.get("grad_accum", 1),
        grad_clip=(ClipGradNormConfig(max_norm=cfg["grad_clip_norm"])
                   if cfg.get("grad_clip_norm") else None),
        distributed=cfg.get("distributed"), precision=cfg.get("precision"),
        oss=bool(cfg.get("oss")), sddp=bool(cfg.get("sddp")),
        fsdp=bool(cfg.get("fsdp")), configs=configs,
        seed=cfg.get("seed", 0))
    if "device" in cfg:
        kwargs["device"] = "cuda" if cfg["device"] == "tpu" else cfg["device"]
    kwargs.update(overrides)
    return Stoke(model=model, optimizer=optimizer, loss=_example_loss,
                 **kwargs)
