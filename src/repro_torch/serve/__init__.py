from repro_torch.serve.engine import (SamplingConfig, SparseLogitHead,
                                     complete_static, generate, sample_token,
                                     token_entropy)

__all__ = ["SamplingConfig", "SparseLogitHead", "complete_static",
           "generate", "sample_token", "token_entropy"]
