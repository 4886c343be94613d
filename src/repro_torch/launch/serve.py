"""Serving launcher: batched generate with optional CCP dispatch replicas
(port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --requests 4 --batch 4 --prompt-len 1024 --new-tokens 32 --max-len 2048

builds the model on the card (``--device``, default ``cuda``) with the port's
own random init from ``--seed``, serves the request batches and prints the
tokens per second.  ``--smoke --device cpu`` runs the smoke config on the CPU.
Every arch of the registry serves but the encoder-decoder (whisper), whose
encoder reads audio frames this launcher has none of: it raises
``ValueError`` (the reference's launcher fails there too); serve it through
``ServeEngine.generate(tokens, n_new, embeds=frames)``.
"""

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--slow-factor", type=float, default=0.0,
                    help="artificial delay (s) on odd replicas — demo of CCP "
                         "dispatch over heterogeneous replicas")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import _device
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import CCPDispatcher, ServeEngine

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.enc_dec:
        raise ValueError(f"{args.arch} is an encoder-decoder model: its encoder needs "
                         "(B, enc_frames, d_model) frames, which this launcher has no "
                         "source of; serve it with ServeEngine.generate(tokens, n_new, "
                         "embeds=frames)")
    dev = _device.resolve(args.device)
    model = build_model(cfg)
    params = model.init(args.seed, device=dev)
    engine = ServeEngine(model, params, max_len=args.max_len, device=dev)

    rng = np.random.default_rng(args.seed)
    batches = [
        rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
        for _ in range(args.requests)
    ]

    def make_replica(i):
        def run(b):
            if args.slow_factor and i % 2 == 1:
                time.sleep(args.slow_factor)
            return engine.generate(b, n_new=args.new_tokens)
        return run

    t0 = time.perf_counter()
    if args.replicas > 1:
        disp = CCPDispatcher([make_replica(i) for i in range(args.replicas)])
        results, allocs = disp.run(batches)
        print(f"dispatch allocations: first={allocs[0].tolist()} "
              f"last={allocs[-1].tolist()}")
    else:
        results = [make_replica(0)(b) for b in batches]
    dt = time.perf_counter() - t0
    toks = sum(r.shape[0] * r.shape[1] for r in results)
    print(f"served {len(results)} request batches / {toks} tokens on {dev} "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s)")
    return results


if __name__ == "__main__":
    main()
