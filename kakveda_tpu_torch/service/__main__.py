"""`python -m kakveda_tpu_torch.service` — start the platform API.

    python -m kakveda_tpu_torch.service [--host H] [--port P] [--data-dir D] [--device cpu]

The index lives on the CUDA card unless ``--device`` names another torch
device. SIGINT or SIGTERM stops the server and flushes the GFKB's logs.
"""

import argparse

from kakveda_tpu_torch.service.main import run_server


def main() -> int:
    ap = argparse.ArgumentParser(prog="kakveda_tpu_torch.service")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default=None, help="torch device for the index (default: the CUDA card)")
    args = ap.parse_args()
    return run_server(host=args.host, port=args.port, data_dir=args.data_dir, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
