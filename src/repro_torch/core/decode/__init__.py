"""Decoder in the loop: the incremental LT peeling decoder of the rateless
policies, batched over Monte-Carlo reps (:mod:`.peeling`).

Port of ``repro.core.decode``.  Payload-level decoding (the round-levelized
gather-subtract over :func:`repro_torch.core.fountain.plan_rounds`) lives in
:mod:`repro_torch.kernels.lt_decode`.  The count of device-to-host copies
made by the decoder's loops is ``peeling.host_syncs``.
"""

from . import peeling  # noqa: F401
from .peeling import (  # noqa: F401
    DEC_DMAX,
    DEC_SEED,
    DecoderTables,
    absorb,
    decode_completion,
    decoder_aux,
    finalize_decode,
    init_state,
    make_decoder_code,
    make_tables,
    offline_overhead_samples,
    peel,
    peel_round,
    send_order_ids,
    slot_ids,
)

__all__ = [
    "DEC_DMAX",
    "DEC_SEED",
    "DecoderTables",
    "absorb",
    "decode_completion",
    "decoder_aux",
    "finalize_decode",
    "init_state",
    "make_decoder_code",
    "make_tables",
    "offline_overhead_samples",
    "peel",
    "peel_round",
    "send_order_ids",
    "slot_ids",
]
