"""Architecture configuration system.

Every architecture is a frozen ``ArchConfig``.  Reduced configs for CPU tests
are derived with ``reduced()``.  The field set matches the JAX package's
``configs/base.py`` so a config reads the same on both sides; only
``stablelm_3b`` (family ``dense``, full attention) is ported so far.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

from repro_torch.core.sparsity import SparsityConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str            # "mamba2" | "xlstm"
    state_dim: int = 64  # mamba2 N / mLSTM key dim basis
    expand: int = 2      # d_inner = expand * d_model (mamba2)
    head_dim: int = 64   # mamba2 head dim
    conv_dim: int = 4    # depthwise conv width
    slstm_every: int = 4  # xlstm: every k-th block is sLSTM (others mLSTM)
    chunk: int = 128     # chunked-scan length (training/prefill)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention structure
    attention: str = "full"          # full | swa | local_global | none
    window: int = 4096
    local_global_ratio: int = 0      # gemma3: 5 (5 local : 1 global)
    local_window: int = 1024
    rope_theta: float = 10000.0
    # encoder-decoder (audio family)
    encoder_layers: int = 0
    encoder_seq_divisor: int = 4     # frames = seq_len // divisor
    # multimodal stub frontends
    frontend: Optional[str] = None   # "audio" | "vision"
    num_patches: int = 256           # vision stub prefix length
    # MoE / SSM / hybrid structure
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0       # zamba2: shared attn block cadence
    # whether long_500k decode applies (sub-quadratic path exists)
    subquadratic: bool = False
    # the paper's technique: relaxed N:M sparsity on weight matrices
    sparsity: Optional[SparsityConfig] = SparsityConfig(8, 128, 1)
    sparse_scope: Tuple[str, ...] = ("mlp", "attn_qkv", "attn_o")
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"              # none | full | dots

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256, as the reference does so
        that embedding/logit tables shard evenly (padded logit columns are
        masked to a large negative in decode)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count N for MODEL_FLOPS = 6·N·D."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qkv = d * hd * (self.num_heads + 2 * self.num_kv_heads) + \
            self.num_heads * hd * d
        mlp = 3 * d * f if f else 0
        per_layer = qkv + mlp
        if self.moe:
            per_layer = qkv + self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        if self.ssm and self.ssm.kind == "mamba2":
            di = self.ssm.expand * d
            per_layer = 2 * d * di + di * self.ssm.state_dim * 2 + di * d
        if self.ssm and self.ssm.kind == "xlstm":
            per_layer = 4 * d * 2 * d + 2 * d * d  # proj up/gates/down approx
        total = self.num_layers * per_layer + 2 * v * d
        total += self.encoder_layers * (qkv + mlp)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dense_total = self.param_count()
        all_experts = self.num_layers * self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        active = self.num_layers * self.moe.experts_per_token * 3 * d * self.moe.d_ff_expert
        return int(dense_total - all_experts + active)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            num_layers=min(self.num_layers, 2 if not self.shared_attn_every
                           else self.shared_attn_every + 1),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads > 1 else 1,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            window=min(self.window, 64),
            local_window=32,
            encoder_layers=min(self.encoder_layers, 2),
            num_patches=8,
            sparsity=SparsityConfig(2, 16, 1) if self.sparsity else None,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, experts_per_token=min(
                    self.moe.experts_per_token, 2), d_ff_expert=64)
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk=16,
                slstm_every=self.ssm.slstm_every)
            if self.ssm.kind == "xlstm":
                # layer count must stay a multiple of the sLSTM period
                changes["num_layers"] = self.ssm.slstm_every
        if self.shared_attn_every:
            changes["shared_attn_every"] = 2
            changes["num_layers"] = 5   # 2 periods + 1 tail layer
        if self.attention == "local_global":
            changes["local_global_ratio"] = 2
            changes["num_layers"] = 7   # 2 periods + 1 tail layer
        return dataclasses.replace(self, **changes)


ARCH_IDS = [
    "seamless_m4t_medium",
    "gemma3_1b",
    "internlm2_20b",
    "stablelm_3b",
    "h2o_danube_1_8b",
    "olmoe_1b_7b",
    "llama4_scout_17b_a16e",
    "internvl2_1b",
    "zamba2_7b",
    "xlstm_125m",
]

PORTED_ARCH_IDS = ["stablelm_3b"]


def get_arch(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in PORTED_ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet; ported so far: "
            f"{PORTED_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def choose_group(k_local: int, target_density: float = 1.0 / 16.0,
                 preferred_m: int = 128) -> SparsityConfig:
    """Pick the largest group size M <= preferred_m dividing ``k_local`` such
    that N = M * density is a positive integer (tensor-parallel-sharded
    contraction dims need group boundaries aligned to shard boundaries)."""
    for m in range(min(preferred_m, k_local), 0, -1):
        n = m * target_density
        if k_local % m == 0 and abs(n - round(n)) < 1e-9 and round(n) >= 1:
            return SparsityConfig(int(round(n)), m, 1)
    return SparsityConfig(1, 1, 1)  # degenerate: dense
