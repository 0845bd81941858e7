"""One node's shuffle supplier (UDA's MOFSupplier), run as a process of its
own for the reduce cells whose map outputs are fetched over the wire: the
port's ``DataEngine`` over the node's directory of map outputs, served by
an ``EvLoopShuffleServer`` on 127.0.0.1::

    python3 -m portbench.supplier --dir <node dir> --conf '<json>'

``--conf`` holds the configuration's ``conf`` keys. The supplier binds an
ephemeral port and, once it listens, prints ``{"port": <n>}`` on a line of
its own. It serves until its standard input closes (the driver closes it;
a driver that dies closes it too), then stops the server and the engine,
prints ``{"counters": {...}}`` (its ``net.*`` counters: the bytes it sent
by sendfile and by copy, the requests it served) and exits 0.

It hides the card (``CUDA_VISIBLE_DEVICES`` empty) before torch is
imported, so it holds no card memory, and pins the environment as
``portbench.run`` does. It imports neither JAX nor the JAX package.
"""

import argparse
import json
import os
import sys

from portbench.run import pin_environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.supplier")
    ap.add_argument("--dir", required=True,
                    help="the node's directory of map outputs")
    ap.add_argument("--conf", default="{}",
                    help="the configuration's conf keys, as JSON")
    args = ap.parse_args(argv)
    pin_environment()
    os.environ["CUDA_VISIBLE_DEVICES"] = ""

    import torch
    from uda_tpu_torch.mofserver import DataEngine, DirIndexResolver
    from uda_tpu_torch.net.server import EvLoopShuffleServer
    from uda_tpu_torch.utils.config import Config
    from uda_tpu_torch.utils.metrics import metrics

    conf = Config(json.loads(args.conf))
    engine = DataEngine(DirIndexResolver(args.dir), conf)
    try:
        server = EvLoopShuffleServer(engine, conf, host="127.0.0.1",
                                     port=0).start()
        try:
            print(json.dumps({"port": server.port}), flush=True)
            sys.stdin.buffer.read()
        finally:
            server.stop()
    finally:
        engine.stop()
    counters = {k: v for k, v in sorted(metrics.snapshot().items())
                if k.startswith("net.") and "{" not in k}
    print(json.dumps({"counters": counters,
                      "cuda_initialized": torch.cuda.is_initialized()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
