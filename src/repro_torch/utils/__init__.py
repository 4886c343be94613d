"""The port's single-card tools: :mod:`.roofline` (the H100's peaks and a
step's roofline terms) and :mod:`.trace` (a step's counted operations and
bytes, and its collectives from a ``torch.profiler`` trace)."""
