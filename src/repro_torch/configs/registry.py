"""Registry: --arch <id> -> (full CONFIG, reduced SMOKE)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, shape_applicable

_MODULES = {
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "qwen1.5-110b": "repro_torch.configs.qwen15_110b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def iter_cells():
    """Yield every runnable (arch, shape) dry-run cell + skip records."""
    for aid in ARCH_IDS:
        arch = get_arch(aid)
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(arch, shape)
            yield aid, sname, ok, why
