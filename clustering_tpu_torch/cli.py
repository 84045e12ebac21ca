"""CLI dispatcher of the PyTorch port: ``python -m clustering_tpu_torch
MODE [options]``.

The parser is the JAX package's (``clustering_tpu.cli.build_parser``,
which imports no jax), so flags and defaults are identical. ``density``
runs on the device named by ``CLUSTERING_TORCH_DEVICE`` (default
``cuda``; asking for CUDA where none is available raises). The six host
modes run the JAX package's numpy drivers as they are.
"""

import os
import sys

from clustering_tpu import VERSION_STRING
from clustering_tpu.cli import GENERAL_HELP, _limit_host_threads, build_parser
from clustering_tpu.utils import io
from clustering_tpu.utils.logger import logger, set_verbose

DEVICE_ENV = "CLUSTERING_TORCH_DEVICE"


def density_device():
    """The torch device of the density mode (CLUSTERING_TORCH_DEVICE)."""
    from .ops.engine import resolve_device
    return resolve_device(os.environ.get(DEVICE_ENV, "cuda"))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(GENERAL_HELP)
        return 1
    args = build_parser().parse_args(argv)
    if args.mode is None:
        sys.stderr.write(GENERAL_HELP)
        return 1
    if getattr(args, "nthreads", 0) and args.nthreads > 0:
        _limit_host_threads(args.nthreads)
    device = density_device() if args.mode == "density" else None

    verbose = args.mode == "stats" or getattr(args, "verbose", False)
    set_verbose(verbose)
    logger(f"\n         ~~~ clustering-tpu {VERSION_STRING} ~~~\n"
           f"              ~ {args.mode} ~\n")
    if device is not None:
        logger(f"~~~ using for parallization: {device} (PyTorch)")

    header = io.make_header(args.mode, argv=["clustering"] + argv)
    comments_map = io.default_comments_map()

    try:
        if args.mode == "density":
            from .models import density
            density.main(args, header, comments_map, device)
        elif args.mode == "mpp":
            from clustering_tpu.models import mpp
            mpp.main(args, header, comments_map)
        elif args.mode == "network":
            from clustering_tpu.models import network
            network.main(args, header, comments_map)
        elif args.mode == "coring":
            from clustering_tpu.models import coring
            coring.main(args, header, comments_map)
        elif args.mode == "noise":
            from clustering_tpu.models import noise
            noise.main(args, header, comments_map)
        elif args.mode in ("filter", "stats"):
            from clustering_tpu.models import state_filter
            state_filter.main(args, header, comments_map,
                              list_mode=args.mode == "stats")
    except BrokenPipeError:
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0
    except (OSError, ValueError) as exc:
        if os.environ.get("CLUSTERING_TPU_DEBUG"):
            raise
        print(f"error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
