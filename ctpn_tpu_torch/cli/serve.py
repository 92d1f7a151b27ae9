"""Serve CTPN detection over HTTP with micro-batching on one CUDA card.

    ctpn-torch-serve --artifact data/artifacts/ctpn_synth_f16.npz \
        [--port 8000] [--mode H] [--max-batch 8] [--window-ms 5] \
        [--cfg configs/text.yml] [--set TPU.NMS_FUSED False ...] \
        [--device cuda] [--trace]

The port of ``ctpn_tpu.cli.serve``; see ``ctpn_tpu_torch/serving.py``.
``--device cpu`` runs the port with the kernels' plain versions.
``--trace`` turns the port's tracing on (``utils/timer.py``): ``GET
/healthz`` then reports each span's count, total and longest seconds under
``"spans"``, and a profiler run shows the spans as ``ctpn.*`` ranges.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifact", required=True,
                   help=".npz weights artifact, an orbax artifact "
                        "directory, or a frozen artifact "
                        "(ctpn-torch-export --frozen)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (pass 0.0.0.0 to expose externally)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--mode", default=None, choices=[None, "H", "O"],
                   help="detect mode (default: cfg.TEST.DETECT_MODE)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--window-ms", type=float, default=5.0)
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the warm-up run of each config bucket")
    p.add_argument("--request-timeout", type=float, default=120.0,
                   help="seconds a request may wait before 504 + shed")
    p.add_argument("--cfg", default=None, help="YAML config to merge")
    p.add_argument("--set", dest="set_cfg", nargs="*", default=[],
                   help="cfg key/value overrides")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--trace", action="store_true",
                   help="trace the serving path: span totals under /healthz's "
                        "\"spans\"")
    args = p.parse_args(argv)

    from ctpn_tpu_torch.config import cfg_from_file, cfg_from_list
    from ctpn_tpu_torch.utils import timer

    timer.enable(args.trace)

    if args.cfg:
        cfg_from_file(args.cfg)
    if args.set_cfg:
        cfg_from_list(args.set_cfg)

    from ctpn_tpu_torch.serving import serve

    serve(
        args.artifact,
        host=args.host,
        port=args.port,
        mode=args.mode,
        max_batch=args.max_batch,
        window_ms=args.window_ms,
        warmup_buckets=not args.no_warmup,
        request_timeout_s=args.request_timeout,
        device=args.device,
    )


if __name__ == "__main__":
    main()
