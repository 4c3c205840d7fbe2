"""Frozen dataclass config tree + named presets.

Replaces the reference's scattered ``tf.app.flags`` / hardcoded constants (SURVEY.md C19).
The five BASELINE.json ``configs`` ship as named presets (SURVEY.md §5 "Config/flag system").

A copy of ``vidcap_tpu/config.py`` so the PyTorch package imports nothing of
the JAX one; tests/test_torch_model.py holds the two ``PRESETS`` equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset / input-pipeline config (SURVEY.md C1, C3–C6)."""

    dataset: str = "msvd"                 # msvd | msrvtt | synthetic
    feature_dim: int = 1536               # Inception-ResNet-v2 pooled feature dim
    num_frames: int = 26                  # sampled frames per video
    max_caption_len: int = 30             # tokens incl. <eos>
    vocab_size: int = 12_000              # before padding to lane multiple
    min_word_count: int = 2               # vocab threshold
    num_attributes: int = 400             # multitask attribute vocab (top-K caption words)
    frame_size: int = 299                 # CNN input resolution (IRv2)
    data_dir: str = "data"

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 so the output projection tiles onto the MXU."""
        return _round_up(self.vocab_size, 128)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder / encoder architecture (SURVEY.md C2, C7, C8, C15)."""

    embed_dim: int = 512
    hidden_dim: int = 512
    attn_dim: int = 512
    num_lstm_layers: int = 1
    use_attention: bool = True            # temporal soft attention over frames
    use_backbone: bool = False            # end-to-end mode: IRv2 inside the train graph
    backbone: str = "inception_resnet_v2"
    backbone_remat_every: int = 1         # checkpoint every Nth IRv2 block
    #   (1 = all, N>1 trades HBM headroom for less bwd recompute, 0 = none)
    dropout_rate: float = 0.0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"       # MXU-friendly; logits/losses stay f32
    use_pallas_decoder: bool = False      # fused Pallas decode-step kernel (ops/pallas_decoder.py)


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decoding strategies (SURVEY.md C9–C11)."""

    method: str = "greedy"                # greedy | sample | beam
    beam_width: int = 5
    max_len: int = 30
    length_penalty: float = 0.0           # 0 = raw logprob (reference-style)
    temperature: float = 1.0
    early_exit: bool = True               # serving decodes (greedy + beam):
    #   lax.while_loop, stop at all-finished; training rollouts and throughput
    #   benchmarks always use the static scan
    finished_pool: str = "auto"           # beam finished-hypothesis handling:
    #   "off"  = slot-blocking (finished beams hold an alive slot at zero cost;
    #            cheapest, and with length_penalty=0 provably same-score)
    #   "on"   = true finished pool (im2txt/t2t lineage: all K slots stay live)
    #   "auto" = pool iff length_penalty != 0 — the only regime where the two
    #            can disagree (tests/test_decoding.py adversarial case)
    int8_vocab_projection: bool = False   # beam only: int8×int8 MXU vocab
    #   projection (+10.8% caps/s measured in-jit; quality-preserving on a
    #   trained ckpt — val CIDEr +0.003, artifacts/r5_int8_quality.json — but
    #   NOT bit-identical, so OFF by default; ops/int8_proj.py)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Staged training schedule (SURVEY.md C12–C17, §3.1–3.2, §3.5)."""

    stage: str = "xe"                     # xe | scst | e2e
    batch_size: int = 32
    learning_rate: float = 1e-4
    backbone_lr_scale: float = 0.1        # smaller LR through the CNN in e2e stage
    grad_clip_norm: float = 5.0
    num_steps: int = 10_000
    warmup_steps: int = 0
    lr_schedule: str = "constant"         # constant | cosine | exponential —
    #   applied after warmup; cosine decays to lr_decay_rate·lr over
    #   lr_decay_steps, exponential multiplies by lr_decay_rate every
    #   lr_decay_steps (smooth)
    lr_decay_steps: int = 0               # decay horizon (0 ⇒ num_steps)
    lr_decay_rate: float = 0.1            # cosine floor fraction / exp factor
    weight_decay: float = 0.0
    seed: int = 0
    rng_salt: int = 0                     # nonzero: folded into the rng on a
    #   CROSS-STAGE restore (xe→scst/e2e) so repeated fine-tuning runs off one
    #   checkpoint draw independent sampling streams (seed sweeps). The
    #   checkpoint otherwise carries params+rng+iterator, making train.seed
    #   inert on resume. 0 (default) = bit-exact legacy behavior; exact
    #   mid-stage resume never applies the salt.
    # SCST / RL
    scst_reward: str = "cider"            # cider | cider_bleu
    bleu_mix: float = 0.0                 # weight of BLEU4 in mixed reward
    scst_learning_rate: Optional[float] = None  # policy-gradient fine-tuning LR
    #   (defaults to learning_rate/20 — SCST at the XE rate collapses policies)
    scst_xe_mix: float = 0.0              # λ·XE anchor added to the PG loss
    scst_fused_rollouts: bool = True      # ONE 2B-row forward-only scan for
    #   baseline+sample + teacher-forced re-score (latency-bound step: ~2
    #   scan-equivalents cheaper); False = separate BPTT rollouts (legacy)
    grad_accum: int = 1                   # K>1: split each batch into K equal
    #   microbatches and lax.scan per-microbatch grads into one optimizer
    #   update. Contributions are weighted EXACTLY (token-mean terms by
    #   micro-token-count / full-batch token count, row-mean terms by 1/K), so
    #   the summed gradient equals the full-batch gradient mathematically —
    #   while peak activation memory drops to one microbatch's. This is how
    #   the memory-bound e2e/composed stages reach large EFFECTIVE batch on a
    #   single chip (e.g. e2e_scst_multitask: batch_size=64, grad_accum=8
    #   steps 8-pixel-row microbatches through the IRv2 backbone). Caveat:
    #   with dropout_rate > 0 each microbatch draws its own dropout rng, so
    #   the accumulated gradient is a different (still unbiased) estimator
    #   than the full-batch one — equality holds for deterministic losses.
    # multitask
    attribute_loss_weight: float = 0.0    # >0 enables the auxiliary attribute head
    # input pipeline
    prefetch_depth: int = 0               # >0: host-side background prefetch of
    #   that many batches (exact resume preserved — the consumer-side iterator
    #   state ships with each batch)
    device_feature_bank: bool = False     # park the WHOLE feature tensor
    #   [N_videos, T, D] (+ attributes) in HBM once and gather rows by
    #   video_idx inside the jitted step — per-step host→device payload drops
    #   from ~10 MB (B=64 production dims) to the token rows (~30 KB).
    #   Bit-exact vs the host-transfer path (same f32 rows, same stream).
    #   Feature-mode only (ignored for pixel/e2e inputs). Composes with
    #   sharded training: banks replicate across the mesh so every gather is
    #   chip-local (parallel/sharding.make_sharded_banked_step).
    steps_per_dispatch: int = 1           # >1 (bank mode only): lax.scan K
    #   steps per jitted call — amortizes the per-dispatch host<->device
    #   round-trip that dominates once the bank removes the payload. Same
    #   batch stream, same numerics; checkpoints/evals fire at chunk
    #   boundaries when their cadence is crossed (per-step LOG granularity is
    #   preserved — the scan returns each step's metrics).
    # checkpointing
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 1000
    log_every: int = 50
    eval_every: int = 2000
    eval_method: str = "greedy"           # decode used by periodic validation
    #   + best-CIDEr checkpoint selection. Default greedy (cheap) even for
    #   beam presets — set "beam" to select checkpoints under the deployment
    #   decode (VERDICT r3 weak #6: the mismatch is now an explicit knob)
    donate_state: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism over a TPU mesh (SURVEY.md §2.3)."""

    data_axis: str = "data"
    model_axis: str = "model"
    num_data: int = -1                    # -1 = all devices on the data axis
    num_model: int = 1                    # vocab-dim TP seam, off by default


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "default"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _mk(name: str, **sections) -> Config:
    base = Config(name=name)
    return dataclasses.replace(
        base,
        **{
            k: dataclasses.replace(getattr(base, k), **v)
            for k, v in sections.items()
        },
    )


# The five BASELINE.json "configs", as named presets.
PRESETS = {
    # configs[0]: "MSVD greedy-decode captioning over precomputed CNN features,
    #              1-layer LSTM decoder, batch 32 (CPU-runnable PR1 ref)"
    "msvd_greedy": _mk(
        "msvd_greedy",
        data=dict(dataset="msvd"),
        model=dict(num_lstm_layers=1, use_attention=True),
        decode=dict(method="greedy"),
        train=dict(stage="xe", batch_size=32),
    ),
    # configs[1]: "MSR-VTT temporal-attention LSTM decoder with beam search (width 5)"
    "msrvtt_attn_beam5": _mk(
        "msrvtt_attn_beam5",
        data=dict(dataset="msrvtt", vocab_size=16_000),
        model=dict(use_attention=True),
        decode=dict(method="beam", beam_width=5),
        train=dict(stage="xe", batch_size=64),
    ),
    # configs[2]: "End-to-end: on-device frame sampling + Inception-ResNet feature
    #              extraction fused with attention decoder"
    "e2e_irv2": _mk(
        "e2e_irv2",
        data=dict(dataset="msrvtt"),
        model=dict(use_backbone=True),
        decode=dict(method="greedy"),
        train=dict(stage="e2e", batch_size=8, learning_rate=2e-5),
    ),
    # configs[3]: "Multitask training: XE captioning + auxiliary attribute/classification
    #              heads, shared video encoder"
    "multitask_xe": _mk(
        "multitask_xe",
        data=dict(dataset="msrvtt"),
        model=dict(use_attention=True),
        decode=dict(method="greedy"),
        train=dict(stage="xe", attribute_loss_weight=0.2),
    ),
    # configs[4]: "SCST/REINFORCE CIDEr-optimized training with fully on-device sampling,
    #              reward, and baseline (greedy) rollout"
    "scst_cider": _mk(
        "scst_cider",
        data=dict(dataset="msrvtt"),
        model=dict(use_attention=True),
        decode=dict(method="sample"),
        train=dict(stage="scst", batch_size=32, learning_rate=1e-4,
                   scst_learning_rate=5e-5, scst_xe_mix=0.1,
                   scst_reward="cider", attribute_loss_weight=0.2),
    ),
    # The COMPOSED flagship (SURVEY.md §0.5 stage 3, §3.5; BASELINE north_star
    # "multitask XE+RL loss"): RL (SCST/CIDEr) fine-tuning THROUGH the IRv2
    # backbone, regularized by the multitask attribute head and an XE anchor —
    # the configuration the reference repo is named after. The step encodes
    # pixels exactly once (train/scst.py shared encode); rollouts ride the
    # stop-gradient features, while PG + XE-anchor + attribute gradients all
    # flow into the CNN.
    "e2e_scst_multitask": _mk(
        "e2e_scst_multitask",
        data=dict(dataset="msrvtt"),
        model=dict(use_backbone=True, use_attention=True),
        decode=dict(method="sample"),
        train=dict(stage="scst", batch_size=8, learning_rate=2e-5,
                   scst_learning_rate=1e-6, scst_xe_mix=0.1,
                   scst_reward="cider", attribute_loss_weight=0.2),
    ),
    # tiny synthetic preset used by tests / CI and the benchmark's warm-up path
    "synthetic_tiny": _mk(
        "synthetic_tiny",
        data=dict(dataset="synthetic", feature_dim=64, num_frames=8,
                  max_caption_len=12, vocab_size=256, num_attributes=32),
        model=dict(embed_dim=32, hidden_dim=32, attn_dim=32),
        decode=dict(max_len=12),
        train=dict(batch_size=4, num_steps=20, log_every=5, checkpoint_every=10,
                   learning_rate=3e-3, scst_xe_mix=0.1),
    ),
}


def get_preset(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]


def apply_overrides(cfg: Config, overrides) -> Config:
    """Generic dotted-path config overrides (SURVEY.md §5 config system:
    "frozen dataclass config tree, CLI overrides"): each item is
    ``section.field=value`` (e.g. ``train.learning_rate=1e-4``,
    ``decode.beam_width=3``, ``model.use_attention=false``). The value is
    coerced to the type of the field's CURRENT value — bools accept
    true/false/1/0; ``null``/``none`` sets None; fields currently None are
    parsed as JSON when possible, else kept as strings."""
    import json as _json

    for item in overrides or ():
        path, eq, raw = str(item).partition("=")
        parts = path.split(".")
        if not eq or len(parts) != 2 or not all(parts):
            raise ValueError(
                f"bad override {item!r} — expected section.field=value")
        section, field = parts
        if not hasattr(cfg, section) or section == "name":
            raise ValueError(f"unknown config section {section!r}")
        sub = getattr(cfg, section)
        if not hasattr(sub, field):
            raise ValueError(
                f"unknown field {field!r} in config section {section!r}")
        cur = getattr(sub, field)
        low = raw.strip().lower()
        if low in ("null", "none"):
            # only Optional-typed fields are nullable: nulling e.g.
            # train.learning_rate would surface much later as an opaque
            # TypeError inside optax/jit, far from the CLI (review r4)
            import typing
            hint = typing.get_type_hints(type(sub)).get(field)
            nullable = (cur is None or (hint is not None and type(None)
                                        in typing.get_args(hint)))
            if not nullable:
                raise ValueError(
                    f"{path} is not nullable (current value {cur!r})")
            val = None
        elif isinstance(cur, bool):
            if low in ("true", "1", "yes"):
                val = True
            elif low in ("false", "0", "no"):
                val = False
            else:
                raise ValueError(f"bad bool for {path}: {raw!r}")
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float):
            val = float(raw)
        elif isinstance(cur, str):
            val = raw
        else:
            try:
                val = _json.loads(raw)
            except _json.JSONDecodeError:
                val = raw
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(sub, **{field: val})})
    return cfg
