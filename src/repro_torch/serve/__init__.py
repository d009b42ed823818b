from repro_torch.serve.batcher import BatcherConfig, ContinuousBatcher
from repro_torch.serve.engine import (SamplingConfig, SparseLogitHead,
                                     complete_static, generate,
                                     jitted_decode_step, jitted_prefill,
                                     sample_token, token_entropy)
from repro_torch.serve.faults import (FaultSchedule, TransientStepError,
                                     apply_malformed, corrupt_tokens)
from repro_torch.serve.paged_cache import PageAllocator
from repro_torch.serve.queue import (STATUS_DEADLINE, STATUS_EOS,
                                     STATUS_ERROR, STATUS_LENGTH, STATUS_OK,
                                     STATUS_REJECTED, STATUSES, Completion,
                                     Request, RequestQueue)

__all__ = ["BatcherConfig", "Completion", "ContinuousBatcher",
           "FaultSchedule", "PageAllocator", "Request", "RequestQueue",
           "SamplingConfig", "SparseLogitHead", "STATUSES",
           "STATUS_DEADLINE", "STATUS_EOS", "STATUS_ERROR",
           "STATUS_LENGTH", "STATUS_OK", "STATUS_REJECTED",
           "TransientStepError", "apply_malformed", "complete_static",
           "corrupt_tokens", "generate", "jitted_decode_step",
           "jitted_prefill", "sample_token", "token_entropy"]
