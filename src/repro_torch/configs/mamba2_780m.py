"""mamba2-780m [ssm] — attention-free SSD (state-space duality).

48L d_model=1536 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]

Pure Mamba-2 stack: each block is an SSD mixer (no separate MLP, d_ff=0).
d_inner = expand*d_model = 3072, head_dim 64 => 48 SSD heads, chunk 256.
The paper's attention-kernel technique is inapplicable (attention-free);
AVO's block-shape/pipeline genome axes are reused to tune the SSD kernel
(see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, Block, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=24,                    # unused by SSD path; kept for config parity
    n_kv_heads=24,
    d_ff=0,
    vocab_size=50280,
    pattern=(Block(kind="mamba", mlp="none"),),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk=256, conv_kernel=4, n_groups=1),
    norm="rmsnorm",
    tie_embeddings=True,
)
