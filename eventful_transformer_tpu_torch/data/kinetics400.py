"""A copy of ``eventful_transformer_tpu/data/kinetics400.py`` for the port.

Kinetics-400 loader (reference datasets/kinetics400.py:431-725).

Self-bootstrapping with staged indicator files:
  download (S3 tars + label CSVs) -> unpack -> ffmpeg-decode to JPEG frames
  at a given short edge / fps. Items are (video (T, C, H, W) uint8, class id).

Class ids follow the standard Kinetics convention: index into the
alphabetically sorted class-name list (the reference's inline CLASSES list,
kinetics400.py:13-414, is exactly that ordering — verified sorted).
"""

from __future__ import annotations

import csv
import shutil
from pathlib import Path
from sys import stderr

from eventful_transformer_tpu_torch.data.video import load_frame_stack
from eventful_transformer_tpu_torch.utils.misc import decode_video, download_file, seeded_shuffle

SPLITS = ["train", "test", "val"]

# https://github.com/cvdfoundation/kinetics-dataset/blob/main/k400_downloader.sh
LABEL_DOWNLOADS = {
    split: f"https://s3.amazonaws.com/kinetics/400/annotations/{split}.csv"
    for split in SPLITS
}
VIDEO_DOWNLOADS = {
    split: f"https://s3.amazonaws.com/kinetics/400/{split}/k400_{split}_path.txt"
    for split in SPLITS
}


class Kinetics400:
    def __init__(
        self,
        location,
        split="val",
        decode_size=None,
        decode_fps=None,
        max_tars=None,
        shuffle=True,
        shuffle_seed=42,
        video_transform=None,
    ):
        assert split in SPLITS
        self.video_transform = video_transform
        base_split = split
        if max_tars is not None:
            split = f"{split}_{max_tars}"

        Path(location, split).mkdir(parents=True, exist_ok=True)
        if not self.is_downloaded(location, split):
            self.clean_downloaded(location, split)
            self.download(location, base_split, split, max_tars)
        if not self.is_unpacked(location, split):
            self.clean_unpacked(location, split)
            self.unpack(location, split)
        if not self.is_decoded(location, split, decode_size, decode_fps):
            self.clean_decoded(location, split, decode_size, decode_fps)
            self.decode(location, split, decode_size, decode_fps)

        self.frames_path = Path(location, split, f"frames_{decode_size}_{decode_fps}")
        self.videos_info = self._get_videos_info(
            location, split, decode_size, decode_fps
        )
        if shuffle:
            seeded_shuffle(self.videos_info, shuffle_seed)

    def __len__(self):
        return len(self.videos_info)

    def __getitem__(self, index):
        info = self.videos_info[index]
        video_path = self.frames_path / info["video_id"]
        video = load_frame_stack([video_path / f for f in info["frames"]])
        if self.video_transform is not None:
            video = self.video_transform(video)
        return video, info["label"]

    # -- one-time setup stages (indicator-file gated) -------------------------

    @staticmethod
    def is_downloaded(location, split):
        return Path(location, split, "downloaded").is_file()

    @staticmethod
    def is_unpacked(location, split):
        return Path(location, split, "unpacked").is_file()

    @staticmethod
    def is_decoded(location, split, decode_size, decode_fps):
        return Path(location, split, f"decoded_{decode_size}_{decode_fps}").is_file()

    @staticmethod
    def clean_downloaded(location, split):
        base = Path(location, split)
        (base / "downloaded").unlink(missing_ok=True)
        (base / "labels.csv").unlink(missing_ok=True)
        if (base / "downloads").is_dir():
            shutil.rmtree(base / "downloads")

    @staticmethod
    def clean_unpacked(location, split):
        base = Path(location, split)
        (base / "unpacked").unlink(missing_ok=True)
        if (base / "videos").is_dir():
            shutil.rmtree(base / "videos")

    @staticmethod
    def clean_decoded(location, split, decode_size, decode_fps):
        base = Path(location, split)
        (base / f"decoded_{decode_size}_{decode_fps}").unlink(missing_ok=True)
        folder = base / f"frames_{decode_size}_{decode_fps}"
        if folder.is_dir():
            shutil.rmtree(folder)

    @staticmethod
    def download(location, base_split, split, max_tars):
        base = Path(location, split)
        downloads = base / "downloads"
        downloads.mkdir(exist_ok=True)
        download_file(LABEL_DOWNLOADS[base_split], base / "labels.csv")
        download_file(VIDEO_DOWNLOADS[base_split], downloads / "download_list.txt")
        n = 0
        with open(downloads / "download_list.txt") as download_list:
            for url in download_list:
                if (max_tars is not None) and (n >= max_tars):
                    break
                url = url.strip()
                download_file(url, downloads / url.split("/")[-1])
                n += 1
        print("Downloads complete.", file=stderr, flush=True)
        (base / "downloaded").touch()

    @staticmethod
    def unpack(location, split):
        base = Path(location, split)
        downloads = base / "downloads"
        videos = base / "videos"
        videos.mkdir(exist_ok=True)
        with open(downloads / "download_list.txt") as download_list:
            for url in download_list:
                filepath = downloads / url.strip().split("/")[-1]
                if filepath.exists():
                    print(f"Unpacking {filepath.name}...", file=stderr, flush=True)
                    shutil.unpack_archive(filepath, videos)
        print("Unpacking complete.", file=stderr, flush=True)
        (base / "unpacked").touch()

    @staticmethod
    def decode(location, split, decode_size, decode_fps):
        base = Path(location, split)
        frames = base / f"frames_{decode_size}_{decode_fps}"
        frames.mkdir(exist_ok=True)
        print("Decoding videos...", file=stderr, flush=True)
        for video_path in sorted((base / "videos").glob("*.mp4")):
            ffmpeg_output_args = ["-qscale:v", "2"]
            if decode_size is not None:
                ffmpeg_output_args += [
                    "-filter:v",
                    f"scale={decode_size}:{decode_size}:force_original_aspect_ratio=increase",
                ]
            if decode_fps is not None:
                ffmpeg_output_args += ["-r", f"{decode_fps}"]
            decode_path = frames / video_path.stem
            code = decode_video(
                video_path,
                decode_path,
                name_format="%3d",
                image_format="jpg",
                ffmpeg_output_args=ffmpeg_output_args,
            )
            if code != 0:
                print(f"Decoding failed for {video_path.stem}.", file=stderr, flush=True)
                shutil.rmtree(decode_path)
        print("Decoding complete.", file=stderr, flush=True)
        (base / f"decoded_{decode_size}_{decode_fps}").touch()

    @staticmethod
    def _get_videos_info(location, split, decode_size, decode_fps):
        frames_path = Path(location, split, f"frames_{decode_size}_{decode_fps}")
        labels_file = Path(location, split, "labels.csv")
        with open(labels_file) as csv_file:
            reader = csv.reader(csv_file)
            next(reader)
            rows = list(reader)
        class_ids = {name: i for i, name in enumerate(sorted({r[0] for r in rows}))}
        videos_info = []
        for row in rows:
            video_id = f"{row[1]}_{int(row[2]):06d}_{int(row[3]):06d}"
            video_path = frames_path / video_id
            if not video_path.is_dir():
                continue
            frame_names = sorted(p.name for p in video_path.glob("*.jpg"))
            videos_info.append(
                {"video_id": video_id, "label": class_ids[row[0]], "frames": frame_names}
            )
        videos_info.sort(key=lambda x: x["video_id"])
        return videos_info
