"""A copy of ``eventful_transformer_tpu/data/epic_kitchens.py`` for the port.

EPIC-Kitchens-100 verb-classification loader
(reference datasets/epic_kitchens.py:16-167).

Clips are cut from long videos by CSV start/end times via ffmpeg -ss/-to;
items are (video (T, C, H, W) uint8, verb class id). Videos and the
EPIC_100_{split}.csv annotation files must be placed under ``location``
manually (as in the reference README).
"""

from __future__ import annotations

import csv
import shutil
from pathlib import Path
from sys import stderr

from eventful_transformer_tpu_torch.data.video import load_frame_stack
from eventful_transformer_tpu_torch.utils.misc import decode_video, seeded_shuffle

SPLITS = ["train", "validation"]


class EPICKitchens:
    def __init__(
        self,
        location,
        split="validation",
        shuffle=True,
        shuffle_seed=42,
        video_transform=None,
    ):
        assert split in SPLITS
        self.video_transform = video_transform
        Path(location, split).mkdir(parents=True, exist_ok=True)
        if not self.is_decoded(location, split):
            self.clean_decoded(location, split)
            self.decode(location, split)
        self.frames_path = Path(location, split, "frames")
        self.clips_info = self._get_clips_info(location, split)
        if shuffle:
            seeded_shuffle(self.clips_info, shuffle_seed)

    def __len__(self):
        return len(self.clips_info)

    def __getitem__(self, index):
        info = self.clips_info[index]
        clip_path = self.frames_path / f"{info['clip_id']:05d}"
        video = load_frame_stack(sorted(clip_path.glob("*.jpg")))
        if self.video_transform is not None:
            video = self.video_transform(video)
        return video, info["class_id"]

    @staticmethod
    def is_decoded(location, split):
        return Path(location, split, "decoded").is_file()

    @staticmethod
    def clean_decoded(location, split):
        base = Path(location, split)
        (base / "decoded").unlink(missing_ok=True)
        if (base / "frames").is_dir():
            shutil.rmtree(base / "frames")

    @staticmethod
    def decode(location, split):
        base = Path(location, split)
        frames = base / "frames"
        frames.mkdir(exist_ok=True)
        print("Decoding clips...", file=stderr, flush=True)
        for info in EPICKitchens._get_clips_info(location, split):
            video_path = Path(location, "videos", f"{info['video_id']}.mp4")
            decode_path = frames / f"{info['clip_id']:05d}"
            code = decode_video(
                video_path,
                decode_path,
                name_format="%4d",
                image_format="jpg",
                ffmpeg_input_args=["-ss", info["start_time"], "-to", info["end_time"]],
                ffmpeg_output_args=["-qscale:v", "2"],
            )
            if code != 0:
                print(f"Decoding failed for clip {info['clip_id']}", file=stderr, flush=True)
                shutil.rmtree(decode_path, ignore_errors=True)
        print("Decoding complete.", file=stderr, flush=True)
        (base / "decoded").touch()

    @staticmethod
    def _get_clips_info(location, split):
        clips_info = []
        with open(Path(location, f"EPIC_100_{split}.csv")) as csv_file:
            reader = csv.reader(csv_file)
            next(reader)
            for i, line in enumerate(reader):
                clips_info.append(
                    {
                        "clip_id": i,
                        "video_id": line[2],
                        "start_time": line[4],
                        "end_time": line[5],
                        "label": line[9],
                        "class_id": int(line[10]),
                    }
                )
        return clips_info
