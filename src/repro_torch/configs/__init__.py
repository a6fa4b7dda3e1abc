"""Assigned-architecture registry: ``--arch <id>`` resolution.

One module per architecture (exact public-literature configs) plus reduced
variants for CPU smoke tests. See DESIGN.md §4 for adaptation notes.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    # the paper's own workload is not an LM; see repro.configs.paper
    "paper-exemplar": "repro_torch.configs.paper",
}

ARCH_IDS = [k for k in _MODULES if k != "paper-exemplar"]


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    return mod.CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    """Small same-family variant for one-CPU smoke tests."""
    mod = importlib.import_module(_MODULES[arch])
    return mod.REDUCED


def replace(cfg: ModelConfig, **kw) -> ModelConfig:
    return dataclasses.replace(cfg, **kw)
