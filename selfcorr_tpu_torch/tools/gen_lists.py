"""A Wild6D video-list file from a dataset directory (the port's own copy of
scripts/gen_lists.py).

The reference's per-category train / test lists hold `<object-index>_
<sequence-index>` tokens that index the *sorted* directory listing, which
data/wild6d.py resolves the same way; its `*_list_all.txt` files are the
whole enumeration of the downloaded split. This writes that enumeration for
whatever part of Wild6D is on disk, through data/wild6d.py's write_list.

  python -m selfcorr_tpu_torch.tools.gen_lists <Wild6D>/laptop \
      config/wild6d/lists/laptop_train.txt
  python -m selfcorr_tpu_torch.tools.gen_lists <Wild6D>/test_set/laptop \
      config/wild6d/lists/laptop_test.txt
"""
from __future__ import annotations

import os
import sys

from selfcorr_tpu_torch.data.wild6d import (  # noqa: F401
    enumerate_videos, write_list)


def main(root: str, out_path: str) -> int:
    """Write the list; returns the exit code, 2 when root is missing or
    holds no video."""
    if not os.path.isdir(root):
        print(f"error: dataset directory not found: {root}", file=sys.stderr)
        return 2
    try:
        n = write_list(root, out_path)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"{out_path}: {n} videos from {root}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        raise SystemExit(2)
    raise SystemExit(main(sys.argv[1], sys.argv[2]))
