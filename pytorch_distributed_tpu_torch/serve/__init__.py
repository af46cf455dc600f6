"""serve/ — continuous-batching inference engine over a paged KV pool.

    from pytorch_distributed_tpu_torch.serve import (
        EngineConfig, Request, ServeEngine,
    )

    engine = ServeEngine(model, EngineConfig(num_slots=4, max_len=256))
    h = engine.submit(Request(prompt_ids, max_new_tokens=64,
                              temperature=0.8, top_p=0.95, seed=7))
    engine.run_until_drained()
    print(h.tokens)
"""

from pytorch_distributed_tpu_torch.serve.engine import (
    EngineConfig,
    ServeEngine,
)
from pytorch_distributed_tpu_torch.serve.kv_slots import (
    PagedKVPool,
    SlotLease,
    auto_page_size,
)
from pytorch_distributed_tpu_torch.serve.sampling import (
    TOP_K_OFF,
    TOP_P_OFF,
    filter_logits_rows,
    sample_logits_rows,
)
from pytorch_distributed_tpu_torch.serve.scheduler import (
    Request,
    RequestHandle,
    RequestStatus,
    Scheduler,
)
from pytorch_distributed_tpu_torch.serve.telemetry import ServeTelemetry

__all__ = [
    "EngineConfig", "ServeEngine", "PagedKVPool", "SlotLease",
    "auto_page_size", "TOP_K_OFF", "TOP_P_OFF", "filter_logits_rows",
    "sample_logits_rows", "Request", "RequestHandle", "RequestStatus",
    "Scheduler", "ServeTelemetry",
]
