"""CLI driver: ``python -m ldpc_decoders_tpu.main <channel> <code> <decoder>``.

Mirrors the reference's argparse surface (src/utils.py:21-55 +
src/main.py:54-64): positional channel/code/decoder validated against the
runtime registries, the same sweep/decoder flags, console-or-file logging,
Saver-compatible JSON output — plus batching and sharding flags (--batch,
--seed, --mesh) the reference had no counterpart for.
"""

from __future__ import annotations

import argparse
import logging
import os

from ldpc_decoders_tpu.channels import CHANNELS, DECODER_NAMES
from ldpc_decoders_tpu.codes import get_code_names
from ldpc_decoders_tpu.harness import MonteCarloRunner, RunConfig
from ldpc_decoders_tpu.utils.file import make_dir_if_not_exists, resolve_data_dir_os


def bind_parser_common(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Common output/logging flags (reference utils.py:47-55)."""
    base = resolve_data_dir_os("decoders")
    path_ = lambda p: os.path.abspath(os.path.join(base, p))  # noqa: E731
    parser.add_argument("--data_dir", default=path_("data"),
                        help="location for writing simulation output")
    parser.add_argument("--cache_dir", default=path_("cache"),
                        help="cache directory for ADMMA checkpoints")
    parser.add_argument("--plots_dir", default=path_("plots"),
                        help="save location of plots")
    parser.add_argument("--debug", action="store_true", help="log debug info")
    parser.add_argument("--console", action="store_true",
                        help="log to console instead of <data_dir>/test.log")
    return parser


def setup_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Batched LDPC Monte-Carlo channel simulation")
    parser.add_argument("channel", choices=sorted(CHANNELS.keys()))
    parser.add_argument("code", choices=get_code_names(),
                        help="code name (set FILE_CODES_DIR for file codes)")
    parser.add_argument("decoder", choices=DECODER_NAMES)

    parser.add_argument("--codeword", type=int, default=0, choices=[-1, 0, 1],
                        help="transmitted codeword: 0 all-zero, 1 all-ones, "
                             "-1 random codebook row (small codes only)")
    parser.add_argument("--min-wec", type=int, default=100,
                        help="min word errors to accumulate per sweep point")
    parser.add_argument("--params", nargs="+", type=float, default=[.1, .01],
                        help="channel parameter sweep values")

    parser.add_argument("--max-iter", type=int, default=10,
                        help="max iterations (<=0: run to convergence)")
    parser.add_argument("--mu", type=float, default=3.0, help="ADMM mu")
    parser.add_argument("--eps", type=float, default=1e-5, help="ADMM eps")
    parser.add_argument("--allow-pseudo", action="store_true",
                        help="keep fractional pseudo-codewords (LP/ADMM)")
    parser.add_argument("--layers", nargs="+", type=int, default=[100, 100],
                        help="ADMMA MLP hidden layers")
    parser.add_argument("--train", action="store_true",
                        help="train ADMMA online against the exact projection")
    parser.add_argument("--apprx", type=int, default=-1,
                        help="ADMMA: iterations using the approximate "
                             "projection before switching to exact")

    parser.add_argument("--log-freq", type=float, default=5.0,
                        help="status log cadence, seconds")
    # Batching and sharding knobs (no reference counterpart).
    parser.add_argument("--batch", type=int, default=4096,
                        help="codewords per compiled super-batch chunk")
    parser.add_argument("--seed", type=int, default=0, help="PRNG seed")
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard the batch over an N-device mesh "
                             "(0 = single device)")
    parser.add_argument("--mesh-code", type=int, default=0,
                        help="shard parity checks over an N-device "
                             "'code' mesh axis (EdgeShardedBPDecoder — "
                             "codes too large for one device); combine "
                             "with --mesh M for a 2-D M x N batch x "
                             "code mesh")
    parser.add_argument("--max-words", type=int, default=None,
                        help="safety cap on words per sweep point")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 BP messages (half the message "
                             "bytes; statistically equivalent curves)")
    parser.add_argument("--inf-policy", choices=["reference", "saturate"],
                        default="reference",
                        help="SPA saturation semantics: 'reference' "
                             "reproduces the float64 inf/NaN cascade the "
                             "golden curves depend on; 'saturate' is the "
                             "clean, cheaper policy (docs/PARITY.md)")
    parser.add_argument("--pipeline", type=int, default=4,
                        help="chunks in flight ahead of the host sync "
                             "(matches RunConfig.pipeline)")
    parser.add_argument("--fixed-pipeline", action="store_true",
                        help="disable the adaptive pipeline fill (keep "
                             "the pipeline at full depth even when the "
                             "in-flight words are expected to cross "
                             "min_wec; RunConfig.adaptive_pipeline)")
    parser.add_argument("--profile", action="store_true",
                        help="log per-section LoopProfiler timings")
    return bind_parser_common(parser)


def main(argv=None) -> None:
    args = setup_parser().parse_args(argv)
    level = logging.DEBUG if args.debug else logging.INFO
    if args.console:
        logging.basicConfig(format="%(name)s|%(message)s", level=level)
    else:
        make_dir_if_not_exists(args.data_dir)
        logging.basicConfig(
            filename=os.path.join(args.data_dir, "test.log"), filemode="a",
            format="%(asctime)s,%(msecs)03d|%(name)s|%(levelname)s|%(message)s",
            datefmt="%H:%M:%S", level=level)

    cfg = RunConfig(
        channel=args.channel, code=args.code, decoder=args.decoder,
        params=args.params, codeword=args.codeword, min_wec=args.min_wec,
        max_iter=args.max_iter, mu=args.mu, eps=args.eps,
        allow_pseudo=args.allow_pseudo, layers=args.layers, train=args.train,
        apprx=args.apprx, batch=args.batch, seed=args.seed,
        log_freq=args.log_freq, max_words=args.max_words,
        data_dir=args.data_dir, cache_dir=args.cache_dir,
        msg_dtype="bfloat16" if args.bf16 else "float32",
        pipeline=args.pipeline, profile=args.profile,
        adaptive_pipeline=not args.fixed_pipeline,
        inf_policy=args.inf_policy)

    mesh = None
    if args.mesh_code:
        from ldpc_decoders_tpu.parallel import code_mesh
        mesh = code_mesh(args.mesh_code, args.mesh)
    elif args.mesh:
        from ldpc_decoders_tpu.parallel import batch_mesh
        mesh = batch_mesh(args.mesh)

    print(vars(args))
    MonteCarloRunner(cfg, mesh=mesh).run()


if __name__ == "__main__":
    main()
