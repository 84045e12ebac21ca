"""CLI dispatcher of the PyTorch port: ``python -m clustering_tpu_torch
MODE [options]``.

The parser is a copy of the JAX package's (same modes, flag names,
defaults and required/optional semantics, after the reference's
src/clustering.cpp:67-526). ``density`` runs on the device named by
``CLUSTERING_TORCH_DEVICE`` (default ``cuda``; asking for CUDA where none
is available raises). The six host modes run the port's own copies of the
JAX package's numpy drivers (``models/``), which write the same files.

``density`` runs on several ranks when the environment asks for it, as
the JAX CLI does: ``CLUSTERING_TPU_DISTRIBUTED=1`` with
``CLUSTERING_TPU_COORDINATOR=host:port``, ``CLUSTERING_TPU_NUM_PROCESSES``
and ``CLUSTERING_TPU_PROCESS_ID`` in each process, or ``torchrun
--nproc-per-node K -m clustering_tpu_torch density ...``. The ranks mesh
by the host rule (``parallel.mesh.host_devices``): a rank alone on its
host drives every visible card of it (the JAX layout: one process per
host, its cards dealt by global device index), while ranks that share a
host keep one card each, ``cuda:local_index % device_count`` (torchrun's
layout, or the switches with one process per card).

Runtime switches of the JAX CLI that apply to ``density``:

- ``CLUSTERING_TPU_DEVICE_WARM`` (on unless "0", CUDA only): the first
  device op on a daemon thread while the coordinates are read -- the CUDA
  context, one small op and its synchronize, and the kernel library's
  load (built first if needed), in a ``cli.device_warm`` span on thread
  "device-warm". Its seconds join the populations sub-stage line
  (``t_device_warm``).
- ``CLUSTERING_TPU_PROFILE=<dir>``: the whole run under
  ``torch.profiler`` (the CPU of every thread, and CUDA where it is
  available), written as a Chrome trace to ``<dir>/trace.json``
  (``trace.rank<r>.json`` in a process group) when ``main`` ends, also on
  an error exit. Each span of the port (``utils.timer``) opened while it
  records shows in it as an annotation of its name on its own thread,
  on the trace's clock.
- ``CLUSTERING_TPU_PROFILE_SUBSTAGES``: each device stage's sub-stage
  times in the ``-v`` log (``[populations substages: ...]``), and as the
  log's last line, ``[spans] {json}``: every span and counter of the run
  (``utils.timer.line``).

The run's spans on the main thread: ``cli.start`` from the process's
creation (from ``main``'s call on a later call in the process) to the
mode's start, the read of the coordinates for ``density``, with
``cli.imports`` (torch and the port's modules) inside it; the density
mode's own (``models.density``); ``cli.teardown``, which joins the
device warm and writes the trace.
"""

import argparse
import os
import sys
import threading

from . import VERSION_STRING
from .utils import io, timer
from .utils.logger import is_verbose, logger, set_verbose

GENERAL_HELP = f"""
         ~~~ clustering-tpu {VERSION_STRING} ~~~

clustering-tpu: a TPU-native classification framework for MD data
(format- and semantics-compatible rebuild of moldyn/clustering v1.3.2)

modes:
  density: run density clustering
  network: build network from density clustering results
  mpp:     run MPP (Most Probable Path) clustering
           (based on density-results)
  coring:  boundary corrections for clustering results.
  noise:   defining and dynamically reassigning noise.
  filter:  filter phase space (e.g. dihedrals) for given state
  stats:   give statistics of state trajectory

usage:
  clustering MODE --option1 --option2 ...

for a list of available options per mode, run with '-h' option, e.g.
  clustering density -h

this binary is parallelized with PyTorch and CUDA on an NVIDIA GPU
"""


def _add_common(p):
    p.add_argument("-n", "--nthreads", type=int, default=0,
                   help="number of host threads (caps the native text-IO"
                        " parser and BLAS pools; device compute is"
                        " controlled by the JAX runtime). 0 = auto.")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode: print runtime information to STDOUT.")


def _add_concat(p):
    p.add_argument("--concat-nframes", dest="concat_nframes", type=int,
                   help="input (parameter): no. of frames per (equally"
                        " sized) sub-trajectory for concatenated trajectory"
                        " files.")
    p.add_argument("--concat-limits", dest="concat_limits",
                   help="input (file): file with sizes of individual (not"
                        " equally sized) sub-trajectories for concatenated"
                        " trajectory files. e.g.: for a concatenated"
                        " trajectory of three chunks of sizes 100, 50 and"
                        " 300 frames: '100 50 300'")


def build_parser():
    parser = argparse.ArgumentParser(
        prog="clustering", add_help=False,
        description=GENERAL_HELP,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="mode")

    # density
    d = sub.add_parser(
        "density",
        description="perform clustering of MD data based on phase space"
                    " densities.\ndensities are approximated by counting"
                    " neighboring frames inside\na n-dimensional hypersphere"
                    " of specified radius.\ndistances are measured with"
                    " n-dim P2-norm.",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    d.add_argument("-f", "--file", required=True,
                   help="input (required): phase space coordinates (space"
                        " separated ASCII).")
    d.add_argument("-r", "--radius", type=float,
                   help="parameter: hypersphere radius. If not used, the"
                        " lumping radius will be used instead.")
    d.add_argument("-T", "--threshold-screening", dest="threshold_screening",
                   type=float, nargs="*",
                   help="parameters: screening of free energy landscape."
                        " format: FROM STEP TO; e.g.: '-T 0.1 0.1 11.1'."
                        " set -T -1 for default values: FROM=0.1, STEP=0.1,"
                        " TO=MAX_FE. parameters may be given partially."
                        " for threshold-screening, --output denotes the"
                        " basename only; output files will have the current"
                        " threshold limit appended to the given filename.")
    d.add_argument("-o", "--output",
                   help="output (optional): clustering information.")
    d.add_argument("-i", "--input",
                   help="input (optional): initial state definition.")
    d.add_argument("-R", "--radii", type=float, nargs="+",
                   help="parameter: list of radii for population/free energy"
                        " calculations (i.e. compute populations/free"
                        " energies for several radii in one go).")
    d.add_argument("-p", "--population",
                   help="output (optional): population per frame (if -R is"
                        " set: this defines only the basename).")
    d.add_argument("-d", "--free-energy", dest="free_energy",
                   help="output (optional): free energies per frame (if -R"
                        " is set: this defines only the basename).")
    d.add_argument("-D", "--free-energy-input", dest="free_energy_input",
                   help="input (optional): reuse free energy info.")
    d.add_argument("-b", "--nearest-neighbors", dest="nearest_neighbors",
                   help="output (optional): nearest neighbor info.")
    d.add_argument("-B", "--nearest-neighbors-input",
                   dest="nearest_neighbors_input",
                   help="input (optional): reuse nearest neighbor info.")
    d.add_argument("--check", action="store_true",
                   help="validation mode: run every device kernel on both"
                        " the Pallas and XLA backends and report any"
                        " disagreement (the functional-purity analog of the"
                        " reference's sanitizer builds).")
    _add_common(d)

    # mpp
    m = sub.add_parser(
        "mpp",
        description="performs a most probable path (MPP) clustering based"
                    " on the given lag time.")
    m.add_argument("-s", "--states", required=True,
                   help="(required): file with state information (i.e."
                        " clustered trajectory)")
    m.add_argument("-D", "--free-energy-input", dest="free_energy_input",
                   required=True,
                   help="input (required): reuse free energy info.")
    m.add_argument("-l", "--lagtime", type=int, required=True,
                   help="input (required): lagtime in units of frame"
                        " numbers. Note: Lagtime should be greater than the"
                        " coring time/ smallest timescale.")
    m.add_argument("--qmin-from", dest="qmin_from", type=float, default=0.01,
                   help="initial Qmin value (default: 0.01).")
    m.add_argument("--qmin-to", dest="qmin_to", type=float, default=1.0,
                   help="final Qmin value (default: 1.00).")
    m.add_argument("--qmin-step", dest="qmin_step", type=float, default=0.01,
                   help="Qmin stepping (default: 0.01).")
    _add_concat(m)
    m.add_argument("--tprob",
                   help="input (file): initial transition probability"
                        " matrix. -l still needs to be given, but will be"
                        " ignored. Format: three space-separated columns"
                        " 'state_from' 'state_to' 'probability'")
    m.add_argument("-o", "--output", default="mpp",
                   help="output (optional): basename for output files"
                        " (default: 'mpp').")
    _add_common(m)

    # network
    n = sub.add_parser("network",
                       description="create a network from screening data.")
    n.add_argument("-p", "--minpop", type=int, required=True,
                   help="(required): minimum population of node to be"
                        " considered for network.")
    n.add_argument("-b", "--basename", default="clust",
                   help="(optional): basename of input files (default:"
                        " clust).")
    n.add_argument("-o", "--output", default="network",
                   help="(optional): basename of output files (default:"
                        " network).")
    n.add_argument("--min", type=float, default=0.1,
                   help="(optional): minimum free energy (default: 0.10).")
    n.add_argument("--max", type=float, default=0.0,
                   help="(optional): maximum free energy (default: 0; i.e."
                        " max. available).")
    n.add_argument("--step", type=float, default=0.1,
                   help="(optional): free energy stepping (default: 0.10).")
    n.add_argument("--network-html", dest="network_html",
                   action="store_true",
                   help="Generate html visualization of fe tree.")
    n.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode: print runtime information to STDOUT.")

    # filter
    f = sub.add_parser(
        "filter",
        description="filter phase space (e.g. dihedral angles, cartesian"
                    " coords, etc.) for given state.")
    f.add_argument("-s", "--states", required=True,
                   help="(required): file with state information (i.e."
                        " clustered trajectory).")
    f.add_argument("-c", "--coords", required=True,
                   help="(required): file with coordinates (either plain"
                        " ASCII or GROMACS' xtc).")
    f.add_argument("-o", "--output",
                   help="basename of filtered data output (extended by e.g."
                        " basename.state5 for state 5) keeping file"
                        " extension of input. If not specified, the input"
                        " name will be used.")
    f.add_argument("-S", "--selected-states", dest="selected_states",
                   type=int, nargs="+",
                   help="state ids of selected states. Default all states.")
    f.add_argument("--every-nth", dest="every_nth", type=int, default=1,
                   help="Take only every nth frame. Default all frames.")
    f.add_argument("--nRandom", dest="n_random", type=int,
                   help="Extract n random frames for each state. The output"
                        " is sorted by indices.")
    f.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode: print runtime information to STDOUT.")

    # stats
    s = sub.add_parser(
        "stats",
        description="list statistics and population of state trajectory.")
    s.add_argument("-s", "--states", required=True,
                   help="(required): file with state information (i.e."
                        " clustered trajectory).")
    _add_concat(s)

    # coring
    c = sub.add_parser(
        "coring",
        description="compute boundary corrections for clustering results.")
    c.add_argument("-s", "--states", required=True,
                   help="(required): file with state information (i.e."
                        " clustered trajectory)")
    c.add_argument("-w", "--windows", required=True,
                   help="(required): either single integer for same window"
                        " for all states or file with window sizes. format"
                        " is space-separated lines of 'STATE_ID"
                        " WINDOW_SIZE'. use * as STATE_ID to match all"
                        " (other) states.")
    c.add_argument("-o", "--output", help="(optional): cored trajectory")
    c.add_argument("-d", "--distribution",
                   help="(optional): write waiting time distributions to"
                        " file.")
    c.add_argument("--cores",
                   help="(optional): write core information to file, i.e."
                        " trajectory with state name if in core region or"
                        " -1 if not in core region")
    _add_concat(c)
    c.add_argument("--iterative", action="store_true",
                   help="increase coring time frame by frame.")
    c.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode: print runtime information to STDOUT.")

    # noise
    x = sub.add_parser(
        "noise",
        description="defining and dynamically reassigning noise for"
                    " clustering results.")
    x.add_argument("-s", "--states", required=True,
                   help="(required): file with state information (i.e."
                        " clustered trajectory)")
    x.add_argument("-o", "--output", required=True,
                   help="(required): noise-reassigned trajectory")
    x.add_argument("-b", "--basename", default="clust",
                   help="(optional): basename of input files (default:"
                        " clust) used to determine isolated clusters")
    x.add_argument("-c", "--cmin", type=float, default=0.1,
                   help="(optional): population (in percent) threshold below"
                        " which an isolated cluster is assigned as noise."
                        " (default: 0.1).")
    x.add_argument("--cores",
                   help="(optional): write core information to file, i.e."
                        " trajectory with state name if in core region or"
                        " -1 if not in core region")
    _add_concat(x)
    x.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode: print runtime information to STDOUT.")

    return parser


def _limit_host_threads(n):
    """Honor -n/--nthreads on the host side (reference:
    clustering.cpp:454-459 wires it to omp_set_num_threads): caps the
    native text-IO thread pool and any BLAS pools numpy has open.
    Device compute is unaffected: PyTorch and the CUDA kernels own it."""
    os.environ.setdefault("OMP_NUM_THREADS", str(n))
    os.environ.setdefault("OPENBLAS_NUM_THREADS", str(n))
    from .utils import textio_native
    textio_native.set_max_threads(n)
    try:
        import threadpoolctl
        threadpoolctl.threadpool_limits(limits=n)
    except Exception:
        pass  # env vars above still cover pools opened later


DEVICE_ENV = "CLUSTERING_TORCH_DEVICE"


def density_device():
    """The torch device of the density mode (CLUSTERING_TORCH_DEVICE); in
    a process group, this rank's."""
    from .ops.engine import resolve_device
    return resolve_device(os.environ.get(DEVICE_ENV, "cuda"))


PROFILE_ENV = "CLUSTERING_TPU_PROFILE"
SUBSTAGES_ENV = "CLUSTERING_TPU_PROFILE_SUBSTAGES"


def _start_device_warm(device):
    """The first device op on a daemon thread (CLUSTERING_TPU_DEVICE_WARM):
    ``torch.cuda.init()``, one small op and a synchronize, and the kernel
    library, in a ``cli.device_warm`` span under the span open here.
    Returns the thread. A failure is left to the stages, which meet it
    again where they need the device (the span records it as its
    ``error``)."""
    import torch
    from .ops import _build

    def work():
        try:
            with timer.span("cli.device_warm"):
                torch.cuda.init()
                torch.ones(8, device=device).add_(1)
                torch.cuda.synchronize(device)
                _build.library()
        except Exception:
            pass

    thread = threading.Thread(target=timer.carried(work), name="device-warm",
                              daemon=True)
    thread.start()
    return thread


def _start_profile():
    """The whole-run trace of CLUSTERING_TPU_PROFILE: a started
    ``torch.profiler.profile`` of the CPU of every thread (a torch
    without ``profile_all_threads`` records the main thread's), and of
    CUDA when available."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    kwargs = {}
    try:
        kwargs["experimental_config"] = torch.profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    prof = profile(activities=activities, **kwargs)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir, distributed):
    """Stop the trace and write it to ``profile_dir`` as a Chrome trace,
    named by the rank in a process group."""
    prof.stop()
    name = "trace.json"
    if distributed:
        import torch.distributed as dist
        name = f"trace.rank{dist.get_rank()}.json"
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, name)
    prof.export_chrome_trace(path)
    logger(f"~~~ profile trace written to {path}")


_STARTED = False


def main(argv=None):
    global _STARTED
    timer.reset()
    # from the process's creation on the first call of the process
    start = timer.span("cli.start", start_ns=None if _STARTED
                       else timer.process_start_ns()).open()
    _STARTED = True
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
    distributed = False
    profile_dir = None
    if args.mode == "density":
        with timer.span("cli.imports"):
            from .models import density  # noqa: F401 (timed here)
            from .parallel import mesh
        if mesh.requested():
            mesh.initialize(os.environ.get(DEVICE_ENV, "cuda"))
            distributed = True
        profile_dir = os.environ.get(PROFILE_ENV)
    prof = _start_profile() if profile_dir else None
    threads = []
    try:
        return _run(args, argv, distributed, start, threads)
    finally:
        start.close()
        with timer.span("cli.teardown"):
            for thread in threads:
                thread.join()
            if prof is not None:
                _stop_profile(prof, profile_dir, distributed)
            if distributed:
                import torch.distributed
                torch.distributed.destroy_process_group()
        if (args.mode == "density" and is_verbose()
                and os.environ.get(SUBSTAGES_ENV)):
            logger(timer.line())


def _run(args, argv, distributed, start, threads):
    """The mode's run; ``start`` is the ``cli.start`` span, closed as the
    mode begins, and ``threads`` receives the threads to join."""
    device = density_device() if args.mode == "density" else None
    if (device is not None and device.type == "cuda"
            and os.environ.get("CLUSTERING_TPU_DEVICE_WARM") != "0"):
        threads.append(_start_device_warm(device))

    verbose = args.mode == "stats" or getattr(args, "verbose", False)
    set_verbose(verbose)
    logger(f"\n         ~~~ clustering-tpu {VERSION_STRING} ~~~\n"
           f"              ~ {args.mode} ~\n")
    if device is not None:
        logger(f"~~~ using for parallization: {device} (PyTorch)")
    if distributed:
        import torch.distributed as dist
        logger(f"~~~ rank {dist.get_rank()} of {dist.get_world_size()}"
               f" ({dist.get_backend()})")

    header = io.make_header(args.mode, argv=["clustering"] + argv)
    comments_map = io.default_comments_map()

    start.close()
    try:
        if args.mode == "density":
            from .models import density
            density.main(args, header, comments_map, device)
        elif args.mode == "mpp":
            from .models import mpp
            mpp.main(args, header, comments_map)
        elif args.mode == "network":
            from .models import network
            network.main(args, header, comments_map)
        elif args.mode == "coring":
            from .models import coring
            coring.main(args, header, comments_map)
        elif args.mode == "noise":
            from .models import noise
            noise.main(args, header, comments_map)
        elif args.mode in ("filter", "stats"):
            from .models import state_filter
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
