"""seamless-m4t-medium [audio] — enc-dec multimodal backbone.

12L (encoder) + 12L (decoder), d_model 1024, 16H (GQA kv=16 = MHA),
d_ff 4096, vocab 256206 [arXiv:2308.11596; hf]. The audio frontend is a
stub: input_specs() provides precomputed frame embeddings (B, S/4, d_model).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", kind="encdec",
        n_layers=12, n_enc_layers=12, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
        frontend="audio",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", kind="encdec",
        n_layers=2, n_enc_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        frontend="audio",
    )
