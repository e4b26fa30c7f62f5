"""Build a filelist from a wav directory tree; the port's copy of the repo's
``preprocess.py`` (reference preprocess.py:1-15), with the same flags:

    python -m smart_vocoder_torch.preprocess --wav_dir ./wav_dirs \
        --filelists filelists/train_files_ss.txt [--speaker_map map.json]

Appends every ``**/*.wav`` under ``wav_dir`` to the filelist, one path a
line; with ``--speaker_map`` (a JSON object from a wav's parent directory
name to an integer speaker id) each line is ``path|sid``.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav_dir", default="./wav_dirs")
    parser.add_argument("--filelists", default="filelists/train_files_ss.txt")
    parser.add_argument("--speaker_map", default=None,
                        help="optional JSON file mapping parent-dir name -> integer speaker "
                             "id; when set, lines are written as path|sid")
    args = parser.parse_args(argv)

    speaker_map = None
    if args.speaker_map:
        with open(args.speaker_map, encoding="utf-8") as f:
            speaker_map = json.load(f)

    filenames = glob("{}/**/*.wav".format(args.wav_dir), recursive=True)
    print("start")
    os.makedirs(os.path.dirname(args.filelists) or ".", exist_ok=True)
    with open(args.filelists, "a", encoding="utf-8") as f:
        for filename in filenames:
            if speaker_map is not None:
                sid = speaker_map[os.path.basename(os.path.dirname(filename))]
                f.write(f"{filename}|{sid}\n")
            else:
                f.write(filename + "\n")
    print(f"wrote {len(filenames)} entries to {args.filelists}")


if __name__ == "__main__":
    main()
