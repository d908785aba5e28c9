"""SVC inference from the command line, on the card by default:

    python -m fish_diffusion_tpu_torch.inference.cli --config CONFIG \\
        --checkpoint PARAMS.pkl --input in.wav --output out.wav [--sampler plms]

The flags are those of ``tools/diffusion/inference.py`` (the JAX CLI) plus
``--device``; ``--batch`` treats input and output as directories. The
checkpoint is a pickle of the JAX package's params (see
``SVCInference.load_checkpoint``). Multi-GPU data parallelism (the JAX
CLI's ``--data-parallel``) is not ported yet (ROADMAP Queue 1, The rest:
``parallel/``).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SVC inference, file to file")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--speaker", type=str, default="0")
    parser.add_argument("--pitch-adjust", type=float, default=0)
    parser.add_argument("--sampler-interval", type=int, default=None)
    parser.add_argument("--skip-steps", type=int, default=0)
    parser.add_argument("--sampler", type=str, default=None,
                        choices=[None, "naive", "plms", "unipc"])
    parser.add_argument("--silence-threshold", type=int, default=60)
    parser.add_argument("--max-slice-duration", type=float, default=30.0)
    parser.add_argument("--min-silence-duration", type=float, default=0)
    parser.add_argument("--extract-vocals", action="store_true",
                        help="separate vocals first (not ported: raises)")
    parser.add_argument("--pitches-path", type=str, default=None,
                        help="restore a frame-f0 curve from .json/.npy")
    parser.add_argument("--batch", action="store_true",
                        help="treat input/output as directories")
    parser.add_argument("--batch-segments", type=int, default=0,
                        help="group up to N same-bucket segments per sample "
                        "call (throughput mode; >1 enables batching)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: the card)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .svc import SVCInference

    engine = SVCInference(args.config, args.checkpoint, device=args.device)
    kwargs = dict(
        speaker=args.speaker,
        pitch_adjust=args.pitch_adjust,
        sampler_interval=args.sampler_interval,
        skip_steps=args.skip_steps,
        noise_predictor=args.sampler,
        silence_threshold=args.silence_threshold,
        max_slice_duration=args.max_slice_duration,
        min_silence_duration=args.min_silence_duration,
        extract_vocals=args.extract_vocals,
        pitches_path=args.pitches_path,
        seed=args.seed,
        batch_segments=args.batch_segments,
    )
    if args.batch:
        engine.batch_inference(args.input, args.output, **kwargs)
    else:
        engine.inference(args.input, args.output, **kwargs)


if __name__ == "__main__":
    main()
