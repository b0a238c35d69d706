"""Command line of the PyTorch port: training a voice and converting.

    python -m rvc_maker_tpu_torch.cli preprocess --dataset data/ \\
        --exp-dir exp/ [--sample-rate 48000 --per 3.7]
    python -m rvc_maker_tpu_torch.cli extract --exp-dir exp/ \\
        --rmvpe-path rmvpe.pt --embedder-path hubert_base.pt [--version v2]
    python -m rvc_maker_tpu_torch.cli train --exp-dir exp/ --epochs 200 \\
        [--batch-size 8 --pretrain-g f0G48k.pth --pretrain-d f0D48k.pth]
    python -m rvc_maker_tpu_torch.cli convert --input in.wav \\
        --output out.wav --model model.pth --rmvpe-path rmvpe.pt \\
        --hubert-path hubert_base.pt [--index added.index --index-rate 0.5]
        [--pitch 0 --protect 0.33 --sid 0] [--f0-method fcpe
        --fcpe-path fcpe.pt | crepe-full --crepe-path crepe_full.pth |
        harvest | hybrid[rmvpe+fcpe] ...] [--embedder-path hf_hubert_dir/]
        [--f0-file f0.txt] [--split-audio]

Every weight file is given explicitly; nothing is downloaded.  convert
takes a `.pth` of any decoder the reference writes (NSF-HiFiGAN, an
f0-less model's plain HiFi-GAN, MRF-HiFi-GAN, RefineGAN) and every F0
method of the JAX package but its ONNX predictors; each F0 network's
weights are needed only by the methods that run it.  train writes
NSF-HiFiGAN models of f0.  extract, train and convert run on the card
unless `--device cpu` is passed.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def cmd_preprocess(args) -> int:
    from .pipelines.preprocess import preprocess_dataset

    n = preprocess_dataset(args.dataset, args.exp_dir, args.sample_rate, per=args.per,
                           num_workers=args.cpu_cores, cut=args.cut,
                           effects=args.process_effects)
    print(f"preprocess: {n} segments in {args.exp_dir}")
    return 0


def cmd_extract(args) -> int:
    from .config import preset
    from .models.hubert import load_hubert_pt
    from .models.rmvpe import load_rmvpe_pt
    from .pipelines import extract as ex

    for flag, path in (("--rmvpe-path", args.rmvpe_path),
                       ("--embedder-path", args.embedder_path)):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{flag}: no such file {path!r}")
    cfg = preset(args.version, args.sample_rate)
    hubert = load_hubert_pt(args.embedder_path)
    ex.extract_f0(args.exp_dir, load_rmvpe_pt(args.rmvpe_path), method=args.f0_method,
                  device=args.device)
    ex.extract_embeddings(args.exp_dir, hubert, version=args.version, device=args.device)
    ex.write_mute_fixture(args.exp_dir, cfg, hubert, args.version, device=args.device)
    path = ex.generate_filelist(args.exp_dir, cfg, args.version)
    print(f"extract: wrote {path}")
    return 0


def cmd_train(args) -> int:
    from .config import preset
    from .pipelines.train_loop import train

    cfg = preset(args.version, args.sample_rate)
    train(args.exp_dir, cfg, total_epochs=args.epochs, batch_size=args.batch_size,
          save_every_epoch=args.save_every_epoch, save_only_latest=not args.save_all,
          pretrain_g=args.pretrain_g, pretrain_d=args.pretrain_d,
          author=args.model_author, model_name=args.model_name,
          overtraining_detector=not args.no_overtraining_detector,
          overtraining_threshold=args.overtraining_threshold,
          save_every_weights=not args.no_save_every_weights,
          cache_data=args.cache_data, cleanup=args.cleanup, device=args.device)
    print(f"train: done, weights in {args.exp_dir}")
    return 0


def _f0_weights(method: str, flag: str, path: str, loader):
    """`loader(path)`, for the F0 weights that `method` needs.  An absent
    flag, a missing file or an ONNX predictor raises."""
    if path.endswith(".onnx"):
        raise ValueError(f"{flag} {path!r}: ONNX F0 predictors are not ported")
    if not path:
        raise ValueError(f"--f0-method {method} needs {flag}")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{flag}: no such file {path!r}")
    return loader(path)


def _load_embedder(args):
    """--embedder-path: a transformers HuBERT directory or weights file
    (.safetensors / .bin), or a fairseq .pt; else --hubert-path (fairseq)."""
    from .models.hubert import load_hubert_pt, load_transformers_dir

    if args.embedder_path:
        path = args.embedder_path
        if path.endswith(".onnx"):
            raise ValueError(f"--embedder-path {path!r}: ONNX embedders are not ported")
        if not os.path.exists(path):
            raise FileNotFoundError(f"--embedder-path: no such file or directory {path!r}")
        return load_hubert_pt(path) if path.endswith(".pt") else load_transformers_dir(path)
    if not args.hubert_path:
        raise ValueError("convert needs --hubert-path (fairseq .pt) or --embedder-path")
    if not os.path.isfile(args.hubert_path):
        raise FileNotFoundError(f"--hubert-path: no such file {args.hubert_path!r}")
    return load_hubert_pt(args.hubert_path)


def cmd_convert(args) -> int:
    import numpy as np

    from .interop.pth import load_synthesizer_pth
    from .models.crepe import CAPACITIES, load_crepe_pth
    from .models.fcpe import load_fcpe_ckpt
    from .models.rmvpe import load_rmvpe_pt
    from .pipelines.convert import (ConvertPipeline, ConvertSettings, convert_split,
                                    f0_members)
    from .retrieval.index import load_index
    from .utils.audio import load_audio, save_wav

    for flag, path in (("--model", args.model), ("--input", args.input)):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{flag}: no such file {path!r}")
    method = args.f0_method
    members = f0_members(method)
    rmvpe = fcpe = crepe = None
    if any(m.startswith("rmvpe") for m in members):
        rmvpe = _f0_weights(method, "--rmvpe-path", args.rmvpe_path, load_rmvpe_pt)
    if any(m.startswith("fcpe") for m in members):
        fcpe = _f0_weights(method, "--fcpe-path", args.fcpe_path,
                           lambda p: load_fcpe_ckpt(p)[0])
    crepe_methods = [m for m in members if "crepe" in m]
    if crepe_methods:
        # the capacity is the method's suffix (JAX cli.py:272-274), a
        # hybrid's CREPE member's here
        capacity = crepe_methods[0].split("-")[-1]
        if capacity not in CAPACITIES:
            capacity = "full"
        crepe = _f0_weights(method, "--crepe-path", args.crepe_path,
                            lambda p: load_crepe_pth(p, capacity))
    synth_params, cfg, meta = load_synthesizer_pth(args.model)
    index_vectors = None
    if args.index and args.index_rate > 0:
        index_vectors = load_index(args.index).vectors
    pipe = ConvertPipeline(synth_params, cfg, _load_embedder(args),
                           version=meta.get("version", "v2"), rmvpe_params=rmvpe,
                           fcpe_params=fcpe, crepe_params=crepe,
                           index_vectors=index_vectors, device=args.device)
    settings = ConvertSettings(
        pitch=args.pitch, index_rate=args.index_rate, protect=args.protect,
        f0_method=method, f0_autotune=args.f0_autotune,
        f0_autotune_strength=args.f0_autotune_strength,
        volume_envelope=args.volume_envelope, resample_sr=args.resample_sr,
        hop_length=args.hop_length, filter_radius=args.filter_radius, f0_file=args.f0_file)
    audio = load_audio(args.input, 16000)
    peak = np.abs(audio).max() / 0.95
    if peak > 1:
        audio = audio / peak
    if args.split_audio:
        out = convert_split(pipe, audio, args.sid, settings)
    else:
        out = pipe.convert_utterance(audio, args.sid, settings)
    # convert_utterance resamples to resample_sr only from 16 kHz up
    out_sr = args.resample_sr if args.resample_sr >= 16000 else cfg.sr
    save_wav(args.output, out, out_sr)
    print(f"wrote {args.output} ({len(out) / out_sr:.2f}s @ {out_sr} Hz)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rvc_maker_tpu_torch.cli")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("preprocess", help="slice and normalize a dataset")
    p.add_argument("--dataset", required=True,
                   help="wavs; top level is speaker 0, numeric subdirs are speaker ids")
    p.add_argument("--exp-dir", required=True)
    p.add_argument("--sample-rate", type=int, default=48000)
    p.add_argument("--per", type=float, default=3.7, help="segment seconds")
    p.add_argument("--cpu-cores", type=int, default=2)
    p.add_argument("--no-cut", dest="cut", action="store_false")
    p.add_argument("--no-process-effects", dest="process_effects", action="store_false")
    p.set_defaults(func=cmd_preprocess)

    e = sub.add_parser("extract", help="RMVPE f0 + HuBERT features, filelist")
    e.add_argument("--exp-dir", required=True)
    e.add_argument("--version", default="v2", choices=["v1", "v2"])
    e.add_argument("--sample-rate", type=int, default=48000)
    e.add_argument("--f0-method", default="rmvpe", choices=["rmvpe", "rmvpe-legacy"])
    e.add_argument("--rmvpe-path", required=True, help="reference rmvpe.pt")
    e.add_argument("--embedder-path", required=True,
                   help="fairseq HuBERT/ContentVec .pt")
    e.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    e.set_defaults(func=cmd_extract)

    t = sub.add_parser("train", help="train a voice from an extracted exp dir")
    t.add_argument("--exp-dir", required=True)
    t.add_argument("--version", default="v2", choices=["v1", "v2"])
    t.add_argument("--sample-rate", type=int, default=48000)
    t.add_argument("--epochs", type=int, default=200)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--save-every-epoch", type=int, default=5)
    t.add_argument("--save-all", action="store_true",
                   help="keep a checkpoint per save epoch, not only the latest")
    t.add_argument("--pretrain-g", default="", help="reference pretrained G .pth")
    t.add_argument("--pretrain-d", default="", help="reference pretrained D .pth")
    t.add_argument("--model-name", default="")
    t.add_argument("--model-author", default="")
    t.add_argument("--no-overtraining-detector", action="store_true")
    t.add_argument("--overtraining-threshold", type=int, default=50)
    t.add_argument("--no-save-every-weights", action="store_true",
                   help="export inference weights only at the end")
    t.add_argument("--cache-data", action="store_true",
                   help="keep decoded training items in RAM")
    t.add_argument("--cleanup", action="store_true",
                   help="delete old checkpoints and weights first")
    t.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    t.set_defaults(func=cmd_train)
    c = sub.add_parser("convert", help="convert one utterance")
    c.add_argument("--input", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--model", required=True,
                   help="interchange .pth voice model, any of the reference's decoders")
    c.add_argument("--rmvpe-path", default="",
                   help="reference rmvpe.pt; needed by the rmvpe methods")
    c.add_argument("--hubert-path", default="", help="fairseq HuBERT/ContentVec .pt")
    c.add_argument("--embedder-path", default="",
                   help="transformers HuBERT directory or weights file (in place "
                        "of --hubert-path)")
    c.add_argument("--f0-method", default="rmvpe",
                   help="rmvpe | rmvpe-legacy | yin | pyin | fcpe | fcpe-legacy | dio | "
                        "harvest | swipe | pm | crepe-{tiny,small,medium,large,full} | "
                        "mangio-crepe-{...} | hybrid[a+b]")
    c.add_argument("--fcpe-path", default="", help="reference fcpe.pt / fcpe_legacy.pt")
    c.add_argument("--crepe-path", default="", help="reference crepe_<capacity>.pth")
    c.add_argument("--f0-file", default="", help='external "time,f0" contour')
    c.add_argument("--hop-length", type=int, default=160,
                   help="frame hop of mangio-crepe and pyin")
    c.add_argument("--filter-radius", type=int, default=3)
    c.add_argument("--f0-autotune", action="store_true")
    c.add_argument("--f0-autotune-strength", type=float, default=1.0)
    c.add_argument("--volume-envelope", type=float, default=1.0)
    c.add_argument("--resample-sr", type=int, default=0)
    c.add_argument("--split-audio", action="store_true",
                   help="convert the voiced pieces between silences")
    c.add_argument("--index", default="",
                   help=".npz index, faiss .index (added_*.index) or total_fea.npy")
    c.add_argument("--index-rate", type=float, default=0.5)
    c.add_argument("--pitch", type=int, default=0)
    c.add_argument("--protect", type=float, default=0.33)
    c.add_argument("--sid", type=int, default=0)
    c.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    c.set_defaults(func=cmd_convert)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if hasattr(args, "device"):
        import torch

        from .device import use_full_fp32

        use_full_fp32(torch.device(args.device))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
