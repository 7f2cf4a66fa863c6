"""ImageNet VID loader (port of ``eventful_transformer_tpu/data/vid.py``;
reference datasets/vid.py:52-345).

One-time unpack from a manually-placed data.tar; COCO-style JSON annotations
converted xywh -> xyxy and 1-based -> 0-based labels; videos with
non-contiguous frame numbering split into separate sequences; items are
:class:`VIDItem` (a per-frame dataset, since some videos are very long)."""

from __future__ import annotations

import json
import shutil
from collections import defaultdict
from copy import deepcopy
from pathlib import Path
from sys import stderr

import numpy as np

from eventful_transformer_tpu_torch.data.video import read_image_chw
from eventful_transformer_tpu_torch.utils.image import rescale
from eventful_transformer_tpu_torch.utils.misc import seeded_shuffle

CLASSES = [
    "airplane", "antelope", "bear", "bicycle", "bird", "bus", "car", "cattle",
    "dog", "domestic cat", "elephant", "fox", "giant panda", "hamster",
    "horse", "lion", "lizard", "monkey", "motorcycle", "rabbit", "red panda",
    "sheep", "snake", "squirrel", "tiger", "train", "turtle", "watercraft",
    "whale", "zebra",
]

SPLITS = ["det_train", "vid_train", "vid_val", "vid_minival"]


class VID:
    def __init__(
        self,
        location,
        split="vid_val",
        tar_path=None,
        shuffle=True,
        shuffle_seed=42,
        frame_transform=None,
        annotation_transform=None,
        combined_transform=None,
    ):
        assert split in SPLITS
        self.frame_transform = frame_transform
        self.annotation_transform = annotation_transform
        self.combined_transform = combined_transform
        if not self.is_unpacked(location):
            assert tar_path is not None, "place data.tar and pass tar_path"
            self.clean_unpacked(location)
            self.unpack(location, Path(tar_path))
        self.frames_path = Path(location, split, "frames")
        self.video_info = self._get_videos_info(location, split)
        if shuffle:
            seeded_shuffle(self.video_info, shuffle_seed)

    def __len__(self):
        return len(self.video_info)

    def __getitem__(self, index):
        info = self.video_info[index]
        video_path = self.frames_path / info["video_id"]
        frame_paths = [str(video_path / f["filename"]) for f in info["frames"]]
        annotations = [f["annotations"] for f in info["frames"]]
        return VIDItem(
            frame_paths,
            annotations,
            self.frame_transform,
            self.annotation_transform,
            self.combined_transform,
        )

    @staticmethod
    def is_unpacked(location):
        return Path(location, "unpacked").is_file()

    @staticmethod
    def clean_unpacked(location):
        base = Path(location)
        (base / "unpacked").unlink(missing_ok=True)
        for split in SPLITS:
            if (base / split).is_dir():
                shutil.rmtree(base / split)

    @staticmethod
    def unpack(location, tar_path):
        base = Path(location)
        base.mkdir(exist_ok=True, parents=True)
        print(f"Unpacking {tar_path.name}...", file=stderr, flush=True)
        shutil.unpack_archive(tar_path, base)
        unpacked = base / "vid_data"
        print("Reorganizing data...", file=stderr, flush=True)
        for split in SPLITS:
            split_path = base / split
            split_path.mkdir(exist_ok=True)
            (unpacked / "annotations" / f"{split}.json").rename(split_path / "labels.json")
        for split in SPLITS[:-1]:
            frames = base / split / "frames"
            frames.mkdir(exist_ok=True)
            for filename in (unpacked / split).glob("*.JPEG"):
                video_id, frame_number = filename.stem.split("_")[-2:]
                video_path = frames / video_id
                video_path.mkdir(exist_ok=True)
                filename.rename(video_path / f"{frame_number}.jpg")
        link_from = base / SPLITS[-1] / "frames"
        link_to = base / SPLITS[-2] / "frames"
        link_from.symlink_to(link_to.resolve(), target_is_directory=True)
        shutil.rmtree(unpacked)
        (base / "unpacked").touch()

    @staticmethod
    def _get_videos_info(location, split):
        with Path(location, split, "labels.json").open() as json_file:
            json_data = json.load(json_file)
        frame_dict = {}
        for item in json_data["images"]:
            video_id, frame_number = Path(item["file_name"]).stem.split("_")[-2:]
            frame_dict[item["id"]] = {
                "video_id": video_id,
                "filename": f"{frame_number}.jpg",
                "annotations": {"boxes": [], "labels": []},
            }
        for item in json_data["annotations"]:
            annotations = frame_dict[item["image_id"]]["annotations"]
            x, y, w, h = item["bbox"]
            annotations["boxes"].append([x, y, x + w, y + h])
            annotations["labels"].append(item["category_id"] - 1)
        video_dict = defaultdict(list)
        for frame in frame_dict.values():
            ann = frame["annotations"]
            ann["boxes"] = np.asarray(ann["boxes"], np.float32).reshape(-1, 4)
            ann["labels"] = np.asarray(ann["labels"], np.int32)
            video_dict[frame.pop("video_id")].append(frame)
        videos_info = []
        for video_id, video in video_dict.items():
            video.sort(key=lambda v: v["filename"])
            last = None
            segment = []
            for frame in video:
                i = int(Path(frame["filename"]).stem)
                if (last is not None) and (i > last + 1):
                    videos_info.append({"video_id": video_id, "frames": segment})
                    segment = []
                segment.append(frame)
                last = i
            if segment:
                videos_info.append({"video_id": video_id, "frames": segment})
        videos_info.sort(key=lambda v: v["video_id"] + v["frames"][0]["filename"])
        return videos_info


class VIDItem:
    """Per-frame dataset over one video segment (reference vid.py:259-314)."""

    def __init__(
        self, frame_paths, annotations, frame_transform, annotation_transform,
        combined_transform,
    ):
        self.frame_paths = frame_paths
        self.annotations = annotations
        self.frame_transform = frame_transform
        self.annotation_transform = annotation_transform
        self.combined_transform = combined_transform

    def __len__(self):
        return len(self.frame_paths)

    def __getitem__(self, index):
        frame = read_image_chw(self.frame_paths[index])
        if self.frame_transform is not None:
            frame = self.frame_transform(frame)
        annotations = self.annotations[index]
        if self.annotation_transform is not None:
            annotations = self.annotation_transform(annotations)
        if self.combined_transform is not None:
            return self.combined_transform((frame, annotations))
        return frame, annotations


class VIDResize:
    """Joint frame + box resize (reference vid.py:319-345): scale =
    min(short_edge_length / short, max_size / long). The frame comes back as
    a float32 numpy array in [0, 1], resized on the host."""

    def __init__(self, short_edge_length, max_size):
        self.short_edge_length = short_edge_length
        self.max_size = max_size

    def __call__(self, x):
        frame, annotations = x
        short_edge = min(frame.shape[-2:])
        long_edge = max(frame.shape[-2:])
        scale = min(self.short_edge_length / short_edge, self.max_size / long_edge)
        frame = rescale(np.asarray(frame, np.float32) / 255.0, scale).numpy()
        annotations = deepcopy(annotations)
        annotations["boxes"] = annotations["boxes"] * scale
        return frame, annotations
