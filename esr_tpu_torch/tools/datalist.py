"""Train / valid datalists over ``*.h5`` globs (the port's own copy of
``esr_tpu/tools/datalist.py``), as a function and a CLI. Four seeded
sampling modes (the same ``random.sample`` draws, so a seed gives the
reference's splits):

- mode 0: ``num`` training recordings, no validation split;
- mode 1: ``num`` training, then ``valid_num`` validation from the rest;
- mode 2: ``portion`` of the glob for training, the rest for validation;
- mode 3: training from ``data_path``, validation from ``valid_data_path``.

Usage: ``python -m esr_tpu_torch.tools.datalist --data_path d --mode 2 --portion 0.9``
"""

from __future__ import annotations

import argparse
import glob
import os
import random
from typing import List, Optional, Tuple


def write_txt(path: str, data: List[str]) -> None:
    with open(path, "w") as f:
        f.writelines(str(i) + "\n" for i in data)


def _globbed(path: str) -> List[str]:
    assert os.path.exists(path), path
    return sorted(glob.glob(os.path.join(path, "*.h5")))


def generate_datalist(
    data_path: str,
    mode: int,
    num: Optional[int] = None,
    valid_num: Optional[int] = None,
    portion: Optional[float] = None,
    valid_data_path: Optional[str] = None,
    seed: int = 123,
) -> Tuple[List[str], List[str]]:
    """Returns ``(train_list, valid_list)`` (valid empty for mode 0)."""
    data_paths = _globbed(data_path)
    n = len(data_paths)

    if mode == 0:
        num = n if num is None else num
        assert 0 < num <= n, f"num must be in (0, {n}], got {num}"
        random.seed(seed)
        return sorted(random.sample(data_paths, num)), []

    if mode == 1:
        assert num is not None and valid_num is not None
        assert 0 < num < n and 0 < valid_num < n and num + valid_num <= n
        random.seed(seed)
        train = random.sample(data_paths, num)
        left = sorted(set(data_paths) - set(train))
        random.seed(seed)
        valid = sorted(random.sample(left, valid_num))
        return train, valid

    if mode == 2:
        assert portion is not None
        train_num = int(n * portion)
        random.seed(seed)
        train = random.sample(data_paths, train_num)
        valid = sorted(set(data_paths) - set(train))
        return train, valid

    if mode == 3:
        assert valid_data_path is not None and num is not None and valid_num is not None
        valid_paths = _globbed(valid_data_path)
        random.seed(seed)
        train = sorted(random.sample(data_paths, num))
        random.seed(seed)
        valid = sorted(random.sample(valid_paths, valid_num))
        return train, valid

    raise ValueError(f"invalid mode {mode}")


def main() -> None:
    p = argparse.ArgumentParser(description="generate train/valid datalists")
    p.add_argument("--data_path", required=True)
    p.add_argument("--valid_data_path", default=None)
    p.add_argument("--num", type=int, default=None)
    p.add_argument("--valid_num", type=int, default=None)
    p.add_argument("--portion", type=float, default=None)
    p.add_argument("--mode", type=int, choices=[0, 1, 2, 3], required=True)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--out_dir", type=str, default=".")
    p.add_argument("--train_txt_name", type=str, default="train.txt")
    p.add_argument("--valid_txt_name", type=str, default="valid.txt")
    flags = p.parse_args()

    train, valid = generate_datalist(
        flags.data_path,
        flags.mode,
        num=flags.num,
        valid_num=flags.valid_num,
        portion=flags.portion,
        valid_data_path=flags.valid_data_path,
        seed=flags.seed,
    )
    os.makedirs(flags.out_dir, exist_ok=True)
    write_txt(os.path.join(flags.out_dir, flags.train_txt_name), train)
    print(f"wrote {len(train)} training items")
    if valid:
        write_txt(os.path.join(flags.out_dir, flags.valid_txt_name), valid)
        print(f"wrote {len(valid)} validation items")


if __name__ == "__main__":
    main()
