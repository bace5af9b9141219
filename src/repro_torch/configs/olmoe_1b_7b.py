"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16 = MHA)
expert d_ff=1024 vocab=50304; 64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", kind="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=0, vocab=50304,
        n_experts=64, n_shared_experts=0, top_k=8, d_expert=1024,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke", kind="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=512,
        n_experts=8, n_shared_experts=0, top_k=2, d_expert=32,
    )
