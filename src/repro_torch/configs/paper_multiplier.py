"""The paper's own configuration: a compact LM whose MLP GEMMs run
through the segmented-carry-chain approximate multiplier in its faithful
bit-exact mode (n=8, t=4, fix-to-1 on) — the configuration used by the
error-metric benchmarks and the approximate-training example."""

import dataclasses

from repro_torch.configs.base import ApproxConfig
from repro_torch.configs.qwen3_0_6b import CONFIG as _QWEN3

CONFIG = dataclasses.replace(
    _QWEN3,
    name="paper-multiplier",
    approx=ApproxConfig(
        enabled=True, n=8, t=4, fix_to_1=True, mode="bitexact", targets=("mlp",)
    ),
)
