"""vid_demo with REPP post-processing on by default (counterpart of
tools/vid_demo_wpost.py)."""

import sys

from .vid_demo import make_parser, run


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--post" not in argv:
        argv.append("--post")
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
