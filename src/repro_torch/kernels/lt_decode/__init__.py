from .kernel import lt_decode_plan_cuda, lt_decode_round_cuda  # noqa: F401
from .ops import lt_decode, lt_decode_code  # noqa: F401
from .ref import lt_decode_program_ref, lt_decode_ref, peel_round_ref  # noqa: F401
from .schedule import plan_program, read_program, round_program, scan_program  # noqa: F401
