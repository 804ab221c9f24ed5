"""Permissive config reader for MaskFlownet YAML files.

A copy of acfm_video_3d_reconstruction_tpu/flow/config.py (numpy only; the
port imports nothing of the JAX package).

Parity target: reference multiframe/data/optical_flow/config_folder/
__init__.py (Reader) — wraps a nested dict so that missing keys resolve to
a `get(default)`-able placeholder, letting the net read
`config.network.flow_multiplier.get(1.)` whether or not the YAML sets it.
Used to resolve the network class + hyperparameters from the reference's
MaskFlownet.yaml / sintel.yaml when converting checkpoints.
"""
from __future__ import annotations

from typing import Any, Mapping


class Reader:
    """Attribute/`.value` access over a nested mapping with defaults."""

    def __init__(self, value: Any = None):
        self.value = value

    def get(self, default: Any = None) -> Any:
        return default if self.value is None else self.value

    def __getattr__(self, name: str) -> "Reader":
        if isinstance(self.value, Mapping) and name in self.value:
            return Reader(self.value[name])
        return Reader(None)

    def __getitem__(self, name: str) -> "Reader":
        return getattr(self, name)

    def __repr__(self):
        return f"Reader({self.value!r})"


def load_yaml(path: str) -> Reader:
    import yaml

    with open(path) as f:
        return Reader(yaml.safe_load(f))


def network_class(model_cfg: Reader) -> str:
    """'MaskFlownet' or 'MaskFlownet_S' from a model YAML
    (reference predict.py:42: eval(config_model...network.class))."""
    return model_cfg.network["class"].get("MaskFlownet")


def flow_multiplier(data_cfg: Reader) -> float:
    return float(data_cfg.network.flow_multiplier.get(1.0))
