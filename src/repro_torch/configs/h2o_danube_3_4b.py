"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000  [arXiv:2401.16818; unverified]
"""
from repro_torch.configs.base import ArchConfig, Block

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    pattern=(Block(kind="attn", window=4096, mlp="gated_silu"),),
    tie_embeddings=False,
)
