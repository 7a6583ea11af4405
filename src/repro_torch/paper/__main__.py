"""Train (or restore) the zoo and both muxes and compute the paper's
Table I, Table II, Fig. 1 and Fig. 6.

    python -m repro_torch.paper --scale smoke --device cpu
    python -m repro_torch.paper --scale full           # on the card
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.paper import (common, fig1_expertise, fig6_separation,
                               table1_mobile_cloud, table2_cloud_api)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=common.SCALES, default=None,
                    help="bench_config scale (default: REPRO_BENCH_SCALE "
                         "or std)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cache = common.STATE_DIR
    state = common.get_state(scale=args.scale, device=args.device,
                             cache_dir=cache)
    print(f"# trained or restored in {state['train_s']:.1f} s "
          f"({state['scale']}, {state['device']})")
    for runner in (fig1_expertise, table1_mobile_cloud, table2_cloud_api):
        runner.run(state)
    fig6_separation.run(state, ablation=common.get_state(
        contrastive=False, scale=args.scale, device=args.device,
        cache_dir=cache))
    return 0


if __name__ == "__main__":
    sys.exit(main())
