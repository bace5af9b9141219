"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attn+mamba heads, sliding-window
attention + 128 meta tokens [arXiv:2411.13676; hf]. SSM branch carries
global context; see DESIGN.md §Arch-applicability for the SWA note."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", kind="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001,
        d_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        window=1024, n_meta_tokens=128,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", kind="hybrid",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        d_state=8, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
        window=32, n_meta_tokens=8,
    )
