"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000  [arXiv:2408.00118; hf]

head_dim=128 (d_q=4096 != d_model, per the HF config); sliding window 4096 on
alternating (local) layers; attention softcap 50, final-logit softcap 30;
gemma-style RMSNorm(1+w), post-layer norms, sqrt(d_model) embedding scaling.
"""
from repro_torch.configs.base import ArchConfig, Block

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=(
        Block(kind="attn", window=4096, mlp="gated_gelu"),   # local
        Block(kind="attn", window=None, mlp="gated_gelu"),   # global
    ),
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
    scale_embeddings=True,
    tie_embeddings=True,
)
