"""One CLI job: ``python -m bench_port.cli_job <density CLI arguments>``.

Runs ``clustering_tpu_torch.cli.main`` on the arguments in this fresh
process, with the CLI's defaults (its warms on, every visible card), then
prints on a line of its own ``bench_port.cli_job {...}``: the peak
``torch.cuda.max_memory_allocated`` and ``max_memory_reserved`` over the
visible cards and any JAX module found loaded. Exits with the CLI's code,
or ``FORBIDDEN_EXIT`` where JAX or the JAX package was loaded.
"""

import json
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "clustering_tpu")
FORBIDDEN_EXIT = 97
MARK = "bench_port.cli_job "


def peaks():
    import torch
    if not torch.cuda.is_available():
        return 0, 0
    devs = range(torch.cuda.device_count())
    return (max(torch.cuda.max_memory_allocated(d) for d in devs),
            max(torch.cuda.max_memory_reserved(d) for d in devs))


def main(argv):
    from clustering_tpu_torch import cli
    rc = cli.main(argv)
    allocated, reserved = peaks()
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    sys.stdout.flush()
    print(MARK + json.dumps({"peak_allocated": allocated,
                             "peak_reserved": reserved,
                             "forbidden": found}), flush=True)
    return FORBIDDEN_EXIT if found else rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
