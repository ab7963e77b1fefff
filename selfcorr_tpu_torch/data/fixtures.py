"""On-disk dataset trees for tests and the card's smoke run, written through
utils/imageio (Pillow), in the layouts the readers take:

  wild6d_tree  the Wild6D layout (data/wild6d.py) with the 'duo' synthetic
               videos and their exact GT poses in the test pkl
               (counterpart of scripts/gen_wild6d_fixture.py generate);
  write_list   a Wild6D list file of every <obj>/<seq>/images video under a
               root (data/wild6d.py's, re-exported);
  nocs_tree    one NOCS scene (data/nocs.py): random frames, one laptop
               instance and one bottle (the laptop's `occ`), labels, and
               obj_models/real_test.pkl beside the root (after
               tests/test_datasets.py make_nocs_tree);
  cub_tree     a CUB split (data/cub.py): random JPEG birds, the .mat
               annotations and classes.txt (after
               tests/test_cub_dataset.py make_cub_tree).

Positions in the NOCS and CUB trees scale with the frame size from the
test helpers' (48, 64) and (60, 80).

  python -m selfcorr_tpu_torch.data.fixtures wild6d <root> [--raw_size 320] \
      [--frames_per_video 24]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from selfcorr_tpu_torch.data.synthetic import SyntheticVideos, _rot_x, _rot_y
from selfcorr_tpu_torch.data.wild6d import write_list
from selfcorr_tpu_torch.utils.imageio import write_jpeg, write_png


def _write_video(seq_dir: str, videos: SyntheticVideos, vid: int,
                 n_frames: int, jpg_quality: int = 95):
    img_dir = os.path.join(seq_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    foc = pp = None
    for fid in range(n_frames):
        img, mask, depth, foc, pp = videos.render_frame(vid, fid)
        rgb = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        write_jpeg(os.path.join(img_dir, f"{fid}.jpg"), rgb, jpg_quality)
        write_png(os.path.join(img_dir, f"{fid}-mask.png"),
                  mask.astype(np.uint8) * 255)
        write_png(os.path.join(img_dir, f"{fid}-depth.png"),
                  np.round(depth).astype(np.uint16))
    s = videos.raw
    K = np.array([[foc[0], 0, pp[0]], [0, foc[1], pp[1]], [0, 0, 1.0]])
    # the metadata stores K transposed: the readers take reshape(3, 3).T
    with open(os.path.join(seq_dir, "metadata"), "w") as f:
        json.dump(dict(K=K.T.reshape(-1).tolist(), w=s, h=s, fps=30), f)


def gt_pose(videos: SyntheticVideos, vid: int, fid: int):
    """The ray tracer's GT in the test pkl's convention: column-acting R,
    metric translation of the canonical box's centre, metric size."""
    theta = videos.phase[vid] + 2 * np.pi * fid / videos.n_frames
    R = _rot_x(videos.tilt[vid]) @ _rot_y(theta)
    cb0, size = videos.canonical_box(vid)
    trans = R @ cb0 + np.array([0.0, 0.0, videos.z0[vid]])
    return (R.astype(np.float64), trans.astype(np.float64),
            np.asarray(size, np.float64))


def wild6d_tree(root: str, cat: str = "laptop", n_train_videos: int = 4,
                n_test_videos: int = 2, frames_per_video: int = 24,
                test_frames: int = 6, raw_size: int = 320, seed: int = 0):
    """Train videos under <root>/<cat>, test videos under
    <root>/test_set/<cat> with their pkl GT; returns (train_root,
    test_root). Train and test share the seed, so the same objects."""
    train_root = os.path.join(root, cat)
    test_root = os.path.join(root, "test_set", cat)
    pkl_dir = os.path.join(root, "test_set", "pkl_annotations", cat)
    os.makedirs(pkl_dir, exist_ok=True)
    train = SyntheticVideos(n_train_videos, frames_per_video,
                            raw_size=raw_size, seed=seed, shape="duo")
    for vid in range(n_train_videos):
        # zero-padded names keep the sorted listing in index order
        _write_video(os.path.join(train_root, f"obj{vid:02d}", "seq00"),
                     train, vid, frames_per_video)
    test = SyntheticVideos(n_test_videos, test_frames, raw_size=raw_size,
                           seed=seed, shape="duo")
    for vid in range(n_test_videos):
        obj, seq = f"obj{vid:02d}", "seq00"
        _write_video(os.path.join(test_root, obj, seq), test, vid,
                     test_frames)
        annos = []
        for fid in range(test_frames):
            R, t, size = gt_pose(test, vid, fid)
            annos.append(dict(name=f"{cat}/{obj}/{seq}/{fid}", rotation=R,
                              translation=t, size=size))
        with open(os.path.join(pkl_dir, f"{cat}-{obj}-{seq}.pkl"), "wb") as f:
            pickle.dump({"annotations": annos}, f)
    return train_root, test_root


def nocs_tree(root: str, n_frames: int = 3, hw=(48, 64), seed: int = 1):
    """Scene 'scene_1' under root; returns the scene list file (beside
    root). Instance 7 is a laptop (class 5) at box (y0, x0, y1, x1) =
    (10, 20, 30, 50) at (48, 64), instance 3 a bottle (class 1) in front of
    its corner at (24, 44, 36, 58); both models' extents go to
    <root>/../obj_models/real_test.pkl."""
    h, w = hw
    sy, sx = h / 48.0, w / 64.0
    rng = np.random.RandomState(seed)
    scene = os.path.join(root, "scene_1")
    os.makedirs(scene)
    box = np.array([round(10 * sy), round(20 * sx), round(30 * sy),
                    round(50 * sx)])
    other = np.array([round(24 * sy), round(44 * sx), round(36 * sy),
                      round(58 * sx)])
    for f in range(n_frames):
        mask = np.full((h, w), 255, np.uint8)
        mask[box[0]:box[2], box[1]:box[3]] = 7
        mask[other[0]:other[2], other[1]:other[3]] = 3
        base = os.path.join(scene, f"{f:04d}")
        write_png(base + "_mask.png", mask)
        write_png(base + "_color.png",
                  (rng.rand(h, w, 3) * 255).astype(np.uint8))
        write_png(base + "_depth.png",
                  (rng.rand(h, w) * 1000).astype(np.uint16))
        with open(base + "_meta.txt", "w") as fh:
            fh.write("7 5 laptop_norm\n3 1 bottle_norm\n")
        label = dict(instance_ids=[7, 3], class_ids=[5, 1],
                     model_list=["laptop_norm", "bottle_norm"],
                     rotations=[np.eye(3), np.eye(3)],
                     translations=[np.array([0.0, 0.0, 1.0]), np.zeros(3)],
                     scales=[np.float32(0.3), np.float32(0.2)],
                     bboxes=[box, other])
        with open(base + "_label.pkl", "wb") as fh:
            pickle.dump(label, fh)
    models = os.path.join(os.path.dirname(root), "obj_models")
    os.makedirs(models, exist_ok=True)
    with open(os.path.join(models, "real_test.pkl"), "wb") as fh:
        pickle.dump({"laptop_norm": rng.uniform(-0.5, 0.5, (64, 3)),
                     "bottle_norm": rng.uniform(-0.2, 0.2, (64, 3))}, fh)
    list_file = os.path.join(os.path.dirname(root), "list.txt")
    with open(list_file, "w") as fh:
        fh.write("0")
    return list_file


def cub_tree(root: str, n_classes: int = 2, per_class: int = 3,
             hw=(60, 80), split: str = "train", seed: int = 0):
    """A CUB split under root; returns its class list file (beside root).
    Each bird's mask is the box (x 20..59, y 10..49 at (60, 80)), its 15
    keypoints random and visible inside it."""
    import scipy.io as sio
    h, w = hw
    sy, sx = h / 60.0, w / 80.0
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    y0, y1 = round(10 * sy), round(50 * sy)
    x0, x1 = round(20 * sx), round(60 * sx)
    class_lines, entries = [], []
    for c in range(n_classes):
        cname = f"{c + 1:03d}.Bird{c}"
        class_lines += [str(c + 1), cname]
        os.makedirs(os.path.join(root, "images", cname), exist_ok=True)
        for i in range(per_class):
            rel = f"{cname}/img{i}.jpg"
            write_jpeg(os.path.join(root, "images", rel),
                       (rng.rand(h, w, 3) * 255).astype(np.uint8))
            mask = np.zeros((h, w), np.uint8)
            mask[y0:y1, x0:x1] = 1
            parts = np.zeros((3, 15))
            parts[0] = rng.randint(x0, x1, 15)
            parts[1] = rng.randint(y0, y1, 15)
            parts[2] = 1
            entries.append((rel, mask, parts))
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write(" ".join(class_lines))

    images = np.zeros((len(entries),), dtype=[
        ("rel_path", "O"), ("mask", "O"), ("parts", "O"), ("bbox", "O")])
    for i, (rel, mask, parts) in enumerate(entries):
        bbox = np.zeros((1,), dtype=[("x1", "O"), ("y1", "O"), ("x2", "O"),
                                     ("y2", "O")])
        bbox[0] = (x0 + 1, y0 + 1, x1 - 1, y1 - 1)   # 1-based, inclusive
        images[i] = (rel, mask, parts, bbox)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    sio.savemat(os.path.join(root, "data", f"{split}_cub_cleaned.mat"),
                {"images": images})
    sfm = np.zeros((len(entries),), dtype=[
        ("scale", "O"), ("trans", "O"), ("rot", "O")])
    for i in range(len(entries)):
        sfm[i] = (np.float64(50.0 * sx), np.array([30.0 * sx, 30.0 * sy]),
                  np.eye(3))
    os.makedirs(os.path.join(root, "sfm"), exist_ok=True)
    sio.savemat(os.path.join(root, "sfm", f"anno_{split}.mat"),
                {"sfm_anno": sfm})
    list_file = os.path.join(os.path.dirname(root), f"cub_{split}_list.txt")
    with open(list_file, "w") as f:
        f.write(" ".join(str(c) for c in range(n_classes)))
    return list_file


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", choices=["wild6d"])
    ap.add_argument("root")
    ap.add_argument("--frames_per_video", type=int, default=24)
    ap.add_argument("--raw_size", type=int, default=320)
    a = ap.parse_args(argv)
    train_root, test_root = wild6d_tree(
        a.root, frames_per_video=a.frames_per_video, raw_size=a.raw_size)
    for split, r in (("train", train_root), ("test", test_root)):
        out = os.path.join(a.root, f"laptop_{split}.txt")
        print(f"{split}: {write_list(r, out)} videos under {r}, list {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
