"""Architecture config schema.

A copy of the JAX package's ``repro.configs.base`` (the port imports
nothing of ``repro``), kept field for field so that a port config compares
equal to the reference's. Two fields are read differently here:
``pim_kernel_backend`` keeps its allowed values but is ignored — the port
dispatches each kernel by the device of its tensors — and the PIM
comments below name the reference modules whose port counterparts live
under ``repro_torch`` with the same relative paths.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free architectures
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # mixture-of-experts
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1          # MoE FFN on layers with idx % moe_every == 0
    capacity_factor: float = 1.25
    # attention details
    qkv_bias: bool = False
    causal: bool = True
    head_dim: int = 0           # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qk_norm: bool = False       # chameleon-style query/key norm
    # block structure: repeating pattern of block kinds
    block_pattern: tuple[str, ...] = ("attn",)   # attn | mamba | rwkv
    # frontend
    input_mode: str = "tokens"  # tokens | embeddings (audio/vlm STUB frontends)
    # ssm details
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    rwkv_head_dim: int = 64
    # numerics / runtime
    norm_eps: float = 1e-5
    activation: str = "silu"    # silu | gelu
    dtype: str = "bfloat16"
    remat: bool = True
    opt_state_dtype: str = "float32"   # bf16 for >=100B models (fits HBM)
    micro_batches: int = 1             # gradient-accumulation microbatches
    kv_cache_dtype: str = "bfloat16"   # "int8": RAELLA-style low-precision
                                       # cache storage w/ digital scales
    # PIM integration: "off" (bf16), "fast" (centered int8 serving path),
    # "exact" (bit-exact accelerator simulation; small models only),
    # "int8" (ideal 8b-quantized reference — the dequant oracle the exact
    # path must match bit-for-bit at noise 0 / non-saturating ADC).
    # Consumed by repro.models (pim_matmul) and both serve engines; plans
    # come from repro.models.pim.prepare_pim_params.
    pim_mode: str = "off"
    pim_use_pallas: bool = False       # fast path: Pallas kernel vs XLA ref
    # Kernel backend for the repro.kernels.ops registry (fused exact
    # datapath + fast-path matmul): "auto" picks pallas-tpu on TPU and
    # the XLA reference elsewhere; "interpret" forces the Pallas
    # interpreter (bit-identical, slow — CI's kernel leg); "python"
    # forces the crossbar reference loop (exact mode only). The
    # REPRO_KERNEL_BACKEND env var overrides this at dispatch time.
    pim_kernel_backend: str = "auto"
    # Weight slicing fed to the compile step (repro.models.pim_compile):
    # a tuple pins every projection site to that slicing; "adaptive" runs
    # the paper's Algorithm 1 per site (per repeat-layer, per MoE expert,
    # conservative 1b-per-slice lm_head). The compiled plan — not this
    # knob — is what the dispatch path consumes.
    pim_weight_slicing: tuple[int, ...] | str = (4, 2, 2)
    pim_speculation: bool = True       # exact path: dynamic input slicing
    pim_adc_bits: int = 24             # exact path ADC; 24b = lossless
                                       # (contract default), 7 = paper ADC
    pim_search_adc_bits: int = 7       # ADC assumed by the Algorithm-1
                                       # search (paper: the real 7b ADC,
                                       # independent of pim_adc_bits)
    # Analog array model for the exact path (repro.core.backends):
    # "ideal" is the exact integer 2T2R read (fused-kernel eligible);
    # "nonideal" programs every crossbar with the ReRAM nonidealities of
    # the named pim_device_corner (conductance program noise, retention
    # drift, stuck-at fault maps, IR drop), deterministic in
    # pim_device_seed — the "does this plan survive a 3-sigma die?"
    # sweep axis. serve.py exposes it as --device-corner.
    pim_crossbar_backend: str = "ideal"
    pim_device_corner: str = "nominal"  # nominal | 1sigma | 3sigma
    pim_device_seed: int = 0            # die seed (fault maps, write noise)

    def __post_init__(self):
        if self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not divisible by "
                f"pattern length {len(self.block_pattern)}")
        ws = self.pim_weight_slicing
        if isinstance(ws, str):
            if ws != "adaptive":
                raise ValueError(
                    f"{self.name}: pim_weight_slicing must be a slice-width "
                    f"tuple or 'adaptive', got {ws!r}")
        elif sum(ws) != 8 or any(not 1 <= b <= 4 for b in ws):
            raise ValueError(
                f"{self.name}: pim_weight_slicing {ws!r} must cover 8 weight "
                "bits with 1..4b slices (paper: <=4b ReRAM devices)")
        allowed = ("auto", "xla", "interpret", "pallas", "pallas-tpu",
                   "pallas-gpu", "python")
        if self.pim_kernel_backend not in allowed:
            raise ValueError(
                f"{self.name}: pim_kernel_backend "
                f"{self.pim_kernel_backend!r} not in {allowed}")
        if self.pim_crossbar_backend not in ("ideal", "nonideal"):
            raise ValueError(
                f"{self.name}: pim_crossbar_backend "
                f"{self.pim_crossbar_backend!r} not in ('ideal', 'nonideal')")
        corners = ("nominal", "1sigma", "3sigma")  # repro.core.backends.CORNERS
        if self.pim_device_corner not in corners:
            raise ValueError(
                f"{self.name}: pim_device_corner "
                f"{self.pim_device_corner!r} not in {corners}")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def moe_layer(self, pattern_idx: int) -> bool:
        """Is the FFN at this pattern position a MoE FFN?"""
        return self.is_moe and (pattern_idx % self.moe_every == 0)

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = len(self.block_pattern)
        small = dict(
            name=self.name + "-smoke",
            n_layers=pat if self.n_layers >= pat else self.n_layers,
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_heads else 0,
            d_ff=128,
            vocab_size=min(self.vocab_size, 256),
            n_experts=min(self.n_experts, 4),
            head_dim=16 if self.n_heads else 0,
            mamba_d_state=8,
            rwkv_head_dim=16,
            remat=False,
            micro_batches=1,
            capacity_factor=4.0,  # no MoE token drops at smoke scale, so
                                  # forward == prefill+decode exactly
        )
        if self.n_heads and small["n_heads"] % max(small["n_kv_heads"], 1):
            small["n_kv_heads"] = 1
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def active_param_count(self) -> int:
        """Params touched per token: MoE counts only top-k experts."""
        if not self.is_moe:
            return self.param_count()
        total = self.param_count()
        d, f = self.d_model, self.d_ff
        moe_positions = sum(1 for i in range(len(self.block_pattern))
                            if self.moe_layer(i))
        expert_params = self.n_repeats * moe_positions \
            * self.n_experts * 3 * d * f
        active = expert_params * self.experts_per_token / self.n_experts
        return int(total - expert_params + active)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d  # embedding
        if self.input_mode == "tokens":
            total += v * d  # untied LM head
        else:
            total += v * d  # output head only (inputs are embeddings)
        for i, kind in enumerate(self.block_pattern):
            n = self.n_repeats
            if kind == "attn":
                attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
                    + hd * self.n_heads * d
                total += n * (attn + 2 * d)  # + norms
            elif kind == "mamba":
                di = self.mamba_expand * d
                total += n * (2 * d * di + di * self.mamba_conv
                              + di * (2 * self.mamba_d_state + d // 16 + 1)
                              + (d // 16) * di + di * d + d)
            elif kind == "rwkv":
                # 5 square projections + decay LoRA + channel-mix (2 mats
                # + receptance gate)
                total += n * (5 * d * d + 2 * d * 64 + 2 * d
                              + 2 * d * f + d * d)
            if kind in ("attn", "mamba"):
                if self.moe_layer(i):
                    total += n * (d * self.n_experts  # router
                                  + self.n_experts * 3 * d * f)
                elif kind != "mamba" or self.family == "hybrid":
                    total += n * 3 * d * f
        return total
