"""serve/ — continuous-batching inference engine over a paged KV pool.

    from pytorch_distributed_tpu_torch.serve import (
        EngineConfig, Request, ServeEngine, SpecConfig,
    )

    engine = ServeEngine(model, EngineConfig(num_slots=4, max_len=256))
    h = engine.submit(Request(prompt_ids, max_new_tokens=64,
                              temperature=0.8, top_p=0.95, seed=7))
    engine.run_until_drained()
    print(h.tokens)   # equal to the solo generate() call

    # speculative decoding: 1..k+1 tokens per tick, greedy streams
    # still the target's own generate()
    engine = ServeEngine(model, cfg,
                         spec=SpecConfig(draft_model, num_draft_tokens=4))

    # a disaggregated fleet: the prefill tier fills pages and ships them
    # (KV migration), the decode tier owns the tick, a deterministic
    # Router balances on the engines' telemetry, and an InProcPrefixStore
    # prefills a shared prompt once per fleet
    from pytorch_distributed_tpu_torch.serve import (
        InProcPrefixStore, Router,
    )
    store = InProcPrefixStore()
    router = Router(
        prefill=[ServeEngine(model, EngineConfig(role="prefill",
                                                 engine_id=f"p{i}"),
                             prefix_store=store) for i in range(2)],
        decode=[ServeEngine(model, EngineConfig(role="decode",
                                                engine_id=f"d{i}"))
                for i in range(2)],
        store=store)
    router.warm_up(prompt_ids)
    h = router.submit(Request(prompt_ids, max_new_tokens=64))
    router.run_until_drained()   # the stream a solo engine emits
"""

from pytorch_distributed_tpu_torch.serve.disagg import (
    MigrationError,
    MigrationFrame,
    decode_frame,
    encode_frame,
    recv_frame,
    roundtrip_frame,
    send_frame,
)
from pytorch_distributed_tpu_torch.serve.engine import (
    EngineConfig,
    ServeEngine,
    SpecConfig,
)
from pytorch_distributed_tpu_torch.serve.kv_slots import (
    PagedKVPool,
    SlotLease,
    auto_page_size,
    extract_frames,
    frame_f32_nbytes,
    frame_nbytes,
    frame_signature,
    gather_pages,
    init_page_cache,
    scatter_kv,
    splice_frames,
)
from pytorch_distributed_tpu_torch.serve.loadgen import (
    drive,
    prefix_shared_requests,
    uniform_arrivals,
    warm_up,
)
from pytorch_distributed_tpu_torch.serve.prefix_store import (
    InProcPrefixStore,
    PrefixStore,
)
from pytorch_distributed_tpu_torch.serve.router import (
    GaugeBoard,
    Router,
    RouterHandle,
)
from pytorch_distributed_tpu_torch.serve.sampling import (
    TOP_K_OFF,
    TOP_P_OFF,
    filter_logits_rows,
    sample_logits_rows,
)
from pytorch_distributed_tpu_torch.serve.scheduler import (
    PrefillChunk,
    Request,
    RequestHandle,
    RequestStatus,
    Scheduler,
)
from pytorch_distributed_tpu_torch.serve.telemetry import ServeTelemetry

__all__ = [
    "EngineConfig", "GaugeBoard", "InProcPrefixStore", "MigrationError",
    "MigrationFrame", "PagedKVPool", "PrefillChunk", "PrefixStore",
    "Request", "RequestHandle", "RequestStatus", "Router", "RouterHandle",
    "Scheduler", "ServeEngine", "ServeTelemetry", "SlotLease", "SpecConfig",
    "TOP_K_OFF", "TOP_P_OFF", "auto_page_size", "decode_frame", "drive",
    "encode_frame", "extract_frames", "filter_logits_rows",
    "frame_f32_nbytes", "frame_nbytes", "frame_signature", "gather_pages",
    "init_page_cache", "prefix_shared_requests", "recv_frame",
    "roundtrip_frame", "sample_logits_rows", "scatter_kv", "send_frame",
    "splice_frames", "uniform_arrivals", "warm_up",
]
