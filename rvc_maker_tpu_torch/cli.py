"""Command line of the PyTorch port: training a voice and converting.

    python -m rvc_maker_tpu_torch.cli preprocess --dataset data/ \\
        --exp-dir exp/ [--sample-rate 48000 --per 3.7]
    python -m rvc_maker_tpu_torch.cli extract --exp-dir exp/ \\
        [--f0-method rmvpe --rmvpe-path rmvpe.pt | yin | pyin | fcpe
        --fcpe-path fcpe.pt | crepe-tiny --crepe-path crepe_tiny.pth |
        hybrid[rmvpe+yin] ...] [--embedder-path hubert_base.pt] [--version v2]
    python -m rvc_maker_tpu_torch.cli train --exp-dir exp/ --epochs 200 \\
        [--batch-size 8 --pretrain-g f0G48k.pth --pretrain-d f0D48k.pth]
        [--vocoder "MRF HiFi-GAN" | RefineGAN] [--no-pitch-guidance]
        [--bf16] [--checkpointing]
    python -m rvc_maker_tpu_torch.cli index --exp-dir exp/ [--version v2]
    python -m rvc_maker_tpu_torch.cli tensorboard --logdir exp/tb [--port 6006]
    python -m rvc_maker_tpu_torch.cli convert --input in.wav \\
        --output out.wav --model model.pth --rmvpe-path rmvpe.pt \\
        --hubert-path hubert_base.pt [--index added.index --index-rate 0.5]
        [--pitch 0 --protect 0.33 --sid 0] [--f0-method fcpe
        --fcpe-path fcpe.pt | crepe-full --crepe-path crepe_full.pth |
        harvest | hybrid[rmvpe+fcpe] ...] [--embedder-path hf_hubert_dir/
        | hubert.onnx] [--f0-onnx --rmvpe-path rmvpe.onnx]
        [--f0-file f0.txt] [--split-audio] [--preset preset.json]
        [--formant-shifting --formant-qfrency 0.8 --formant-timbre 0.8]
        [--clean-audio --clean-strength 0.7] [--export-format flac]
    python -m rvc_maker_tpu_torch.cli effects --input in.wav --output out.wav \
        [--reverb --reverb-room-size 0.5 --gain --gain-db -3 ...]
    python -m rvc_maker_tpu_torch.cli tts --text "hello" --output tts.wav \
        [--voice en-US-AriaNeural | --google --voice en] [--srt cues.srt]
        [--model model.pth --hubert-path hubert_base.pt --convert-output out.wav
        and the conversion flags of convert]
    python -m rvc_maker_tpu_torch.cli fuse --model-a a.pth --model-b b.pth \
        --output fused.pth [--ratio 0.5]
    python -m rvc_maker_tpu_torch.cli info --model model.pth
    python -m rvc_maker_tpu_torch.cli export-onnx --model model.pth \
        --output model.onnx [--static --max-frames 800]
    python -m rvc_maker_tpu_torch.cli separate --model htdemucs.th | bag.yaml \
        | mdx.onnx --input song.wav --output-vocals v.wav \
        [--output-instrumental i.wav --shifts 1 --invert-using-spec]
        [--mdx-n-fft 6144 --mdx-hop 1024 --mdx-denoise]
    python -m rvc_maker_tpu_torch.cli separate-music --input song.wav \
        --output stems/ --model-name htdemucs.yaml [--backing --kara-model
        kara.onnx] [--reverb --reverb-model reverb.onnx] [--clean-audio]
    python -m rvc_maker_tpu_torch.cli transcribe --model whisper.pt \
        --vocab multilingual.tiktoken --input speech.wav --output segs.json
        [--language en --word-timestamps --beam-size 5 --patience 1.0 --best-of 5]
    python -m rvc_maker_tpu_torch.cli diarize-convert --input talk.wav \
        --output out.wav --model a.pth --model-b b.pth --ecapa ecapa_dir/ \
        --hubert-path hubert_base.pt [--whisper whisper.pt --vocab
        multilingual.tiktoken] and the conversion flags of convert
    python -m rvc_maker_tpu_torch.cli edit --input-path in.wav \
        --output-path out.wav --toy-stack [--source-prompt "piano"
        --target-prompt "violin" --steps 50 --t-start 45 --sample-rate 44100]

Every weight file is given explicitly; nothing is downloaded.  convert
takes a `.pth` of any decoder the reference writes (NSF-HiFiGAN, an
f0-less model's plain HiFi-GAN, MRF-HiFi-GAN, RefineGAN) or a `.onnx`
voice model, a `.onnx` embedder, and every F0 method of the JAX package;
each F0 network's weights are needed only by the methods that run it,
and an rmvpe / fcpe / crepe weight file that ends in `.onnx` runs as an
ONNX predictor (`--f0-onnx` insists on it).  The ONNX graphs run on
--device through `interop/onnx_run.py`.  export-onnx writes a `.pth`
as a `.onnx` voice model (dynamic frame axis unless --static), traced on
the CPU.  extract runs every
F0 method of the JAX package's extract (`.onnx` predictor and embedder
files too); without --rmvpe-path an rmvpe
method falls back to yin, and without --embedder-path the features come
from a random HuBERT (debug only), each with a warning.  train writes
every decoder, in fp32 or bf16, with or without checkpointing; it
downloads no pretrained weights (--no-pretrained is accepted for the
JAX package's command line and changes nothing).  index writes the
`.npz`, `total_fea.npy` and a faiss `added_*.index`.  convert reads
and writes WAV and FLAC (other export formats through ffmpeg), applies
a preset JSON first, shifts the input's formants before the conversion
and spectral-gates its output (`utils/noisereduce.py`, on the device).
separate runs a Demucs `.th`, a `.yaml` bag of them or an MDX-Net `.onnx`;
separate-music chains it with a karaoke split, a dereverb pass and the
noise gate, its registry names resolved only to files already in
$RVC_TPU_ASSETS/models/uvr5 (default assets/).
transcribe cuts 30 s windows, decodes each with the temperature fallback
(beam search at temperature 0 with --beam-size) and aligns words by
cross-attention DTW with --word-timestamps.  diarize-convert clusters
the segments' ECAPA embeddings into one speaker per voice model.
edit inverts the input with edit-friendly DDPM inversion under the
source prompt and re-runs the chain under the target prompt; the
AudioLDM2 checkpoint is read from assets/models/audioldm2/<model> and is
not in the repository, so without --toy-stack (an identity VAE and a
zero denoiser) it raises, as the JAX package's does.
extract, train, index, convert, separate, separate-music, transcribe,
diarize-convert, edit and tts --model run on the card unless
`--device cpu` is passed; effects, fuse and info are host work.  tts
needs the network (the Edge read-aloud service, or Google's with
--google; RVC_TPU_EDGE_TTS_URL names another Edge endpoint).

train runs on several ranks when the environment says so (one process
per rank, `parallel/distributed.py`): RVC_COORDINATOR_ADDRESS=host:port
of rank 0, RVC_NUM_PROCESSES, RVC_PROCESS_ID.  Each rank trains on its
card (cuda:rank mod cards, gloo when ranks share a card, NCCL with a card
each) or on the CPU with --device cpu; --batch-size is each rank's rows.
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
    from .pipelines import extract as ex
    from .pipelines.convert import f0_members
    from .utils.i18n import tr

    cfg = preset(args.version, args.sample_rate)
    if args.embedder_path:
        if not os.path.isfile(args.embedder_path):
            raise FileNotFoundError(f"--embedder-path: no such file {args.embedder_path!r}")
        if args.embedder_path.endswith(".onnx"):
            from .interop.onnx_embedder import OnnxEmbedder

            hubert = OnnxEmbedder(args.embedder_path, device=args.device)
        else:
            hubert = load_hubert_pt(args.embedder_path)
    else:
        from .interop import from_jax

        logging.warning(tr("random_hubert"))
        hubert = from_jax.hubert_from_jax(from_jax.random_hubert_tree(seed=0))
    method = args.f0_method
    members = f0_members(method)
    rmvpe = fcpe = crepe = None
    if any(m.startswith("rmvpe") for m in members):
        if args.rmvpe_path:
            from .models.rmvpe import load_rmvpe_pt

            rmvpe = _f0_weights(method, "--rmvpe-path", args.rmvpe_path, load_rmvpe_pt, args)
        elif method.startswith("rmvpe"):
            logging.warning(tr("fallback_yin"))
            method = "yin"
    fcpe, crepe = _fcpe_crepe(args, method, members)
    ex.extract_f0(args.exp_dir, rmvpe, method=method, fcpe_params=fcpe, crepe_params=crepe,
                  hop_length=args.hop_length, device=args.device)
    ex.extract_embeddings(args.exp_dir, hubert, version=args.version, device=args.device)
    ex.write_mute_fixture(args.exp_dir, cfg, hubert, args.version, device=args.device)
    path = ex.generate_filelist(args.exp_dir, cfg, args.version)
    print(f"extract: wrote {path} (f0 by {method})")
    return 0


def cmd_index(args) -> int:
    import numpy as np

    from .retrieval.index import build_index, save_index
    from .retrieval.ivf import build_ivf_file
    from .utils.i18n import tr

    feat_dir = os.path.join(args.exp_dir, f"{args.version}_extracted")
    arrays = [np.load(os.path.join(feat_dir, n))
              for n in sorted(os.listdir(feat_dir)) if n.endswith(".npy")]
    index = build_index(np.concatenate(arrays, axis=0), version=args.version,
                        device=args.device)
    stem = f"added_{os.path.basename(os.path.normpath(args.exp_dir))}_{args.version}"
    out = os.path.join(args.exp_dir, f"{stem}.index.npz")
    save_index(index, out)
    np.save(os.path.join(args.exp_dir, "total_fea.npy"), index.vectors)
    # the faiss IVF-Flat file that reference tools load (reference
    # create_index.py:66-83: nlist = min(16 sqrt(N), N / 39), nprobe 1)
    fa = os.path.join(args.exp_dir, f"{stem}.index")
    build_ivf_file(index.vectors, fa, device=args.device)
    print(tr("save_index") + f": {index.vectors.shape} -> {out} + {fa}")
    return 0


def cmd_train(args) -> int:
    import dataclasses

    from .config import preset
    from .parallel import distributed as dist_mod
    from .pipelines.train_loop import train

    cfg = preset(args.version, args.sample_rate, vocoder=args.vocoder,
                 pitch_guidance=args.pitch_guidance)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, bf16=args.bf16, remat=args.checkpointing))
    train(args.exp_dir, cfg, total_epochs=args.epochs, batch_size=args.batch_size,
          save_every_epoch=args.save_every_epoch, save_only_latest=not args.save_all,
          pretrain_g=args.pretrain_g, pretrain_d=args.pretrain_d,
          author=args.model_author, model_name=args.model_name,
          overtraining_detector=not args.no_overtraining_detector,
          overtraining_threshold=args.overtraining_threshold,
          save_every_weights=not args.no_save_every_weights,
          cache_data=args.cache_data, cleanup=args.cleanup, device=args.device)
    dist_mod.shutdown()
    print(f"train: done, weights in {args.exp_dir}")
    return 0


def cmd_tensorboard(args) -> int:
    import time

    from .pipelines.tb_logging import launch_tensorboard
    from .utils.i18n import tr

    print(tr("tensorboard_url") + f": {launch_tensorboard(args.logdir, args.port)}",
          flush=True)
    while True:
        time.sleep(60)


def _f0_weights(method: str, flag: str, path: str, loader, args):
    """`loader(path)`, for the F0 weights that `method` needs; a `.onnx`
    file is an ONNX predictor, an `interop.onnx_run.OnnxGraph` on
    args.device.  An absent flag or a missing file raises, and so does a
    file that is not `.onnx` under --f0-onnx."""
    if not path:
        raise ValueError(f"--f0-method {method} needs {flag}")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{flag}: no such file {path!r}")
    onnx = path.endswith(".onnx")
    if getattr(args, "f0_onnx", False) and not onnx:
        raise ValueError(f"--f0-onnx: {flag} {path!r} is not a .onnx predictor")
    if onnx:
        from .interop.onnx_run import OnnxGraph

        return OnnxGraph(path, device=args.device)
    return loader(path)


def _fcpe_crepe(args, method: str, members: list):
    """The FCPE and CREPE weights that `method`'s members need (None when
    they need none); the CREPE capacity is a member's suffix (JAX
    cli.py:272-274)."""
    from .models.crepe import CAPACITIES, load_crepe_pth
    from .models.fcpe import load_fcpe_ckpt

    fcpe = crepe = None
    if any(m.startswith("fcpe") for m in members):
        fcpe = _f0_weights(method, "--fcpe-path", args.fcpe_path,
                           lambda p: load_fcpe_ckpt(p)[0], args)
    crepe_methods = [m for m in members if "crepe" in m]
    if crepe_methods:
        capacity = crepe_methods[0].split("-")[-1]
        if capacity not in CAPACITIES:
            capacity = "full"
        crepe = _f0_weights(method, "--crepe-path", args.crepe_path,
                            lambda p: load_crepe_pth(p, capacity), args)
    return fcpe, crepe


def _load_embedder(args):
    """--embedder-path: a transformers HuBERT directory or weights file
    (.safetensors / .bin), a fairseq .pt, or a `.onnx` embedder (on
    args.device); else --hubert-path (fairseq)."""
    from .models.hubert import load_hubert_pt, load_transformers_dir

    if args.embedder_path:
        path = args.embedder_path
        if not os.path.exists(path):
            raise FileNotFoundError(f"--embedder-path: no such file or directory {path!r}")
        if path.endswith(".onnx"):
            from .interop.onnx_embedder import OnnxEmbedder

            return OnnxEmbedder(path, device=args.device)
        return load_hubert_pt(path) if path.endswith(".pt") else load_transformers_dir(path)
    if not args.hubert_path:
        raise ValueError("convert needs --hubert-path (fairseq .pt) or --embedder-path")
    if not os.path.isfile(args.hubert_path):
        raise FileNotFoundError(f"--hubert-path: no such file {args.hubert_path!r}")
    return load_hubert_pt(args.hubert_path)


def _build_convert_pipeline(args):
    """The conversion pipeline and settings of the conversion flags, shared
    by `convert` and `tts --model` (JAX cli.py:169): every weight file
    given explicitly, on args.device."""
    from .interop.onnx_voice import load_voice_model
    from .models.rmvpe import load_rmvpe_pt
    from .pipelines.convert import ConvertPipeline, ConvertSettings, f0_members
    from .retrieval.index import load_index

    if not os.path.isfile(args.model):
        raise FileNotFoundError(f"--model: no such file {args.model!r}")
    method = args.f0_method
    members = f0_members(method)
    rmvpe = None
    if any(m.startswith("rmvpe") for m in members):
        rmvpe = _f0_weights(method, "--rmvpe-path", args.rmvpe_path, load_rmvpe_pt, args)
    fcpe, crepe = _fcpe_crepe(args, method, members)
    # a .pth gives a params tree, a .onnx an OnnxVoiceModel on args.device
    synth_params, cfg, meta = load_voice_model(args.model, device=args.device)
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
    return pipe, settings


def _out_sr(args, cfg) -> int:
    """The output's sample rate.  convert_utterance resamples to
    --resample-sr only from 16 kHz up, so below that the samples stay at
    the model's rate, and so does their header (JAX writes
    --resample-sr's rate on the model's samples there)."""
    return args.resample_sr if args.resample_sr >= 16000 else cfg.sr


def cmd_convert(args) -> int:
    from .pipelines.convert import convert_split
    from .utils.audio import load_audio, peak_normalize, save_audio, save_wav

    if args.preset:
        from .utils.presets import apply_preset_to_args, load_preset

        apply_preset_to_args(args, load_preset(args.preset))
    if not os.path.isfile(args.input):
        raise FileNotFoundError(f"--input: no such file {args.input!r}")
    pipe, settings = _build_convert_pipeline(args)
    audio = load_audio(args.input, 16000)
    if args.formant_shifting:
        from .utils.pitchshift import formant_shift

        audio = formant_shift(audio, 16000, quefrency=args.formant_qfrency,
                              timbre=args.formant_timbre)
    audio = peak_normalize(audio)
    if args.split_audio:
        out = convert_split(pipe, audio, args.sid, settings)
    else:
        out = pipe.convert_utterance(audio, args.sid, settings)
    out_sr = _out_sr(args, pipe.cfg)
    if args.clean_audio:
        from .utils.noisereduce import reduce_noise

        out = reduce_noise(out, out_sr, prop_decrease=args.clean_strength, device=args.device)
    if args.export_format != "wav":
        written = save_audio(args.output, out, out_sr, args.export_format)
    else:
        save_wav(args.output, out, out_sr)
        written = args.output
    print(f"wrote {written} ({len(out) / out_sr:.2f}s @ {out_sr} Hz)")
    return 0


def cmd_effects(args) -> int:
    from .utils.audio import read_wav, save_wav
    from .utils.effects import EffectsSettings, apply_effects

    audio, sr = read_wav(args.input)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    settings = EffectsSettings(**{f: getattr(args, f)
                                  for f in EffectsSettings.__dataclass_fields__})
    out, out_sr = apply_effects(audio, sr, settings)
    save_wav(args.output, out, out_sr)
    print(f"wrote {args.output} ({len(out) / out_sr:.2f}s @ {out_sr} Hz)")
    return 0


def cmd_tts(args) -> int:
    """Synthesize speech (the Edge read-aloud protocol, or Google
    translate TTS), SRT-timed or not, and with --model convert it through
    a voice on args.device (JAX cli.py:495-528)."""
    from .device import resolve_device
    from .utils import edge_tts_client as etc
    from .utils.audio import peak_normalize, save_wav
    from .utils.i18n import tr
    from .utils.tts import _read_tts_output, srt_tts, synthesize_tts

    if not args.text and not args.srt:
        raise SystemExit(tr("enter_the_text"))
    if args.model:
        resolve_device(args.device)          # no card: raise before any synthesis
    print(tr("start_tts"))
    if args.srt:
        srt_tts(args.srt, args.output, args.voice, rate=args.rate, google=args.google)
    else:
        synthesize_tts(args.text, args.voice, args.output, rate=args.rate,
                       pitch=args.tts_pitch, google=args.google,
                       output_format=None if args.google else etc.PCM_FORMAT)
    print(tr("tts_success") + f" -> {args.output}")
    if args.model:
        pipe, settings = _build_convert_pipeline(args)
        audio16 = peak_normalize(_read_tts_output(args.output, 16000))
        out = pipe.convert_utterance(audio16, args.sid, settings)
        save_wav(args.convert_output, out, _out_sr(args, pipe.cfg))
        print(tr("output_file_tts_convert") + f" -> {args.convert_output}")
    return 0


def cmd_fuse(args) -> int:
    from .utils.i18n import tr
    from .utils.model_tools import fuse_models

    out = fuse_models(args.model_a, args.model_b, args.output, ratio=args.ratio)
    print(tr("fusion_success") + f" -> {out}")
    return 0


def cmd_info(args) -> int:
    import json

    from .utils.model_tools import model_info

    print(json.dumps(model_info(args.model), indent=2, default=str))
    return 0


def cmd_export_onnx(args) -> int:
    from .interop.onnx_voice import export_voice_model

    if not os.path.isfile(args.model):
        raise FileNotFoundError(f"--model: no such file {args.model!r}")
    out = export_voice_model(args.model, args.output, max_frames=args.max_frames,
                             dynamic=not args.static)
    print(f"export-onnx: wrote {out}")
    return 0


def cmd_separate(args) -> int:
    """Vocals / instrumental from a Demucs `.th`, a `.yaml` bag of them or
    an MDX `.onnx`, on args.device (JAX cli.py:343-402)."""
    import numpy as np

    from .utils.audio import read_wav, save_wav
    from .utils.i18n import tr

    if not os.path.isfile(args.input):
        raise FileNotFoundError(f"--input: no such file {args.input!r}")
    audio, sr = read_wav(args.input)
    if args.model.endswith(".onnx"):
        from .interop.onnx_run import OnnxGraph
        from .pipelines import mdx as mdx_mod

        graph = OnnxGraph(args.model, device=args.device)
        p = mdx_mod.params_from_graph(graph, n_fft=args.mdx_n_fft, hop_length=args.mdx_hop,
                                      compensate=args.mdx_compensate, overlap=args.mdx_overlap,
                                      enable_denoise=args.mdx_denoise)
        if audio.ndim == 1:
            audio = np.stack([audio, audio], axis=1)
        vocals, inst = mdx_mod.mdx_separate(graph, audio.T.astype(np.float32), p,
                                            invert_using_spec=args.invert_using_spec)
        # the primary stem is the vocals for Kim_Vocal-style models
        vocals, inst, out_sr = vocals.T, inst.T, sr
    elif args.model.endswith((".yaml", ".yml")):
        from .interop.demucs_load import load_demucs_bag
        from .pipelines.separate import apply_bag

        bag = load_demucs_bag(args.model, device=args.device)
        if audio.ndim == 1:
            audio = np.stack([audio, audio], axis=1)
        out = apply_bag(bag, audio.T[None].astype(np.float32), shifts=args.shifts)
        cfg = bag[0][1]
        v_idx = cfg.sources.index("vocals")
        vocals = out[0, v_idx].T
        inst = sum(out[0, k] for k in range(len(cfg.sources)) if k != v_idx).T
        out_sr = cfg.samplerate
    else:
        from .interop.demucs_load import load_demucs_th
        from .pipelines.separate import separate_vocals

        params, cfg = load_demucs_th(args.model, device=args.device)
        vocals, inst = separate_vocals(params, cfg, audio, sr, shifts=args.shifts,
                                       invert_using_spec=args.invert_using_spec)
        out_sr = cfg.samplerate
    save_wav(args.output_vocals, vocals, out_sr)
    if args.output_instrumental:
        save_wav(args.output_instrumental, inst, out_sr)
    print(tr("separator_success_3") + f" {args.output_vocals}"
          + (f" and {args.output_instrumental}" if args.output_instrumental else ""))
    return 0


def cmd_separate_music(args) -> int:
    """The whole stem chain (JAX cli.py:405-418); model names resolve only
    to files already in the settings' model_dir."""
    from .pipelines.separate_music import SeparationSettings, separate_music
    from .utils.i18n import tr

    s = SeparationSettings(
        model_name=args.model_name, kara_model=args.kara_model,
        reverb_model=args.reverb_model, backing=args.backing, reverb=args.reverb,
        backing_reverb=args.backing_reverb, clean_audio=args.clean_audio,
        clean_strength=args.clean_strength, shifts=args.shifts,
        sample_rate=args.sample_rate, export_format=args.export_format,
        mdx_denoise=args.mdx_denoise, mdx_overlap=args.mdx_overlap, mdx_hop=args.mdx_hop,
        mdx_n_fft=args.mdx_n_fft, device=args.device)
    written = separate_music(args.input, args.output, s)
    print(tr("separator_success_3") + " " + ", ".join(f"{k}: {v}" for k, v in written.items()))
    return 0


def cmd_transcribe(args) -> int:
    """Whisper transcription to a JSON list of segments, with word
    timestamps on request (JAX cli.py:449-470)."""
    import json

    from .models.whisper import load_whisper_pt
    from .speaker.transcribe import transcribe
    from .speaker.whisper_tokenizer import WhisperTokenizer
    from .utils.audio import load_audio
    from .utils.i18n import tr

    for flag, path in (("--input", args.input), ("--model", args.model), ("--vocab", args.vocab)):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{flag}: no such file {path!r}")
    model = load_whisper_pt(args.model, device=args.device)
    tok = WhisperTokenizer(args.vocab, multilingual=True, language=args.language)
    segs = transcribe(model, tok, load_audio(args.input, 16000),
                      word_timestamps=args.word_timestamps, beam_size=args.beam_size,
                      patience=args.patience, best_of=args.best_of)
    out = [{k: v for k, v in s.items() if k != "tokens"} for s in segs]
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2, ensure_ascii=False)
    print(tr("whisper_done") + " " + tr("segments_to", n=len(out), path=args.output))
    return 0


def cmd_edit(args) -> int:
    """Prompt-based audio editing on args.device (JAX cli.py:595-610)."""
    from .edit.pipeline import ToyMelStack, edit
    from .utils.i18n import tr

    out = edit(args.input_path, args.output_path, model_id=args.model,
               source_prompt=args.source_prompt, target_prompt=args.target_prompt,
               steps=args.steps, cfg_scale_src=args.cfg_scale_src,
               cfg_scale_tar=args.cfg_scale_tar, t_start=args.t_start,
               save_compute=args.save_compute, sr=args.sample_rate,
               export_format=args.export_format, device=args.device,
               stack=ToyMelStack(device=args.device) if args.toy_stack else None)
    print(tr("success") + f" -> {out}")
    return 0


def cmd_diarize_convert(args) -> int:
    """Diarized two-model conversion: segment (Whisper with --whisper,
    else an energy VAD), cluster the segments' ECAPA embeddings, convert
    each with its cluster's voice model (JAX cli.py:531-563).  --ecapa is
    an ECAPA checkpoint or a speechbrain directory holding one."""
    import copy

    from .speaker.diarize import convert_with_diarization
    from .speaker.hyperyaml import load_ecapa
    from .utils.audio import load_audio, save_wav

    if not os.path.isfile(args.input):
        raise FileNotFoundError(f"--input: no such file {args.input!r}")
    if not os.path.exists(args.ecapa):
        raise FileNotFoundError(f"--ecapa: no such file or directory {args.ecapa!r}")
    audio16 = load_audio(args.input, 16000)
    pipes, settings_list = [], []
    for model in (args.model, args.model_b or args.model):
        a = copy.copy(args)
        a.model = model
        pipe, settings = _build_convert_pipeline(a)
        pipes.append(pipe)
        settings_list.append(settings)
    whisper = None
    if args.whisper:
        from .models.whisper import load_whisper_pt
        from .speaker.whisper_tokenizer import WhisperTokenizer

        if not os.path.isfile(args.vocab):
            raise FileNotFoundError(f"--whisper needs --vocab, a .tiktoken file: {args.vocab!r}")
        whisper = (load_whisper_pt(args.whisper, device=args.device),
                   WhisperTokenizer(args.vocab, multilingual=True))
    out = convert_with_diarization(audio16, pipes, settings_list,
                                   load_ecapa(args.ecapa, args.device), whisper=whisper)
    save_wav(args.output, out, pipes[0].cfg.sr)
    print(f"wrote {args.output} ({len(out) / pipes[0].cfg.sr:.2f}s @ {pipes[0].cfg.sr} Hz)")
    return 0


def _conversion_flags(c) -> None:
    """The flags of `_build_convert_pipeline`, shared by convert and tts."""
    c.add_argument("--rmvpe-path", default="",
                   help="reference rmvpe.pt; needed by the rmvpe methods")
    c.add_argument("--hubert-path", default="", help="fairseq HuBERT/ContentVec .pt")
    c.add_argument("--embedder-path", default="",
                   help="transformers HuBERT directory or weights file, or a .onnx "
                        "embedder (in place of --hubert-path)")
    c.add_argument("--f0-method", default="rmvpe",
                   help="rmvpe | rmvpe-legacy | yin | pyin | fcpe | fcpe-legacy | dio | "
                        "harvest | swipe | pm | crepe-{tiny,small,medium,large,full} | "
                        "mangio-crepe-{...} | hybrid[a+b]")
    c.add_argument("--fcpe-path", default="", help="reference fcpe.pt / fcpe_legacy.pt")
    c.add_argument("--crepe-path", default="", help="reference crepe_<capacity>.pth")
    c.add_argument("--f0-onnx", action="store_true",
                   help="the F0 networks run as .onnx predictors: --rmvpe-path / "
                        "--fcpe-path / --crepe-path must name .onnx files (a .onnx "
                        "file there runs as one without the flag too)")
    c.add_argument("--f0-file", default="", help='external "time,f0" contour')
    c.add_argument("--hop-length", type=int, default=160,
                   help="frame hop of mangio-crepe and pyin")
    c.add_argument("--filter-radius", type=int, default=3)
    c.add_argument("--f0-autotune", action="store_true")
    c.add_argument("--f0-autotune-strength", type=float, default=1.0)
    c.add_argument("--volume-envelope", type=float, default=1.0)
    c.add_argument("--resample-sr", type=int, default=0,
                   help="output rate, from 16000 up (below it the model's rate)")
    c.add_argument("--index", default="",
                   help=".npz index, faiss .index (added_*.index) or total_fea.npy")
    c.add_argument("--index-rate", type=float, default=0.5)
    c.add_argument("--pitch", type=int, default=0)
    c.add_argument("--protect", type=float, default=0.33)
    c.add_argument("--sid", type=int, default=0)
    c.add_argument("--device", default="cuda", help="cuda (default) or cpu")


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

    e = sub.add_parser("extract", help="f0 + HuBERT features, filelist")
    e.add_argument("--exp-dir", required=True)
    e.add_argument("--version", default="v2", choices=["v1", "v2"])
    e.add_argument("--sample-rate", type=int, default=48000)
    e.add_argument("--f0-method", default="rmvpe",
                   help="rmvpe | rmvpe-legacy | yin | pm | dio | harvest | swipe | pyin | "
                        "crepe-* | mangio-crepe-* | fcpe[-legacy] | hybrid[a+b]")
    e.add_argument("--rmvpe-path", default="",
                   help="reference rmvpe.pt (without it rmvpe falls back to yin)")
    e.add_argument("--embedder-path", default="",
                   help="fairseq HuBERT/ContentVec .pt (without it: random weights)")
    e.add_argument("--crepe-path", default="", help="reference crepe_<capacity>.pth")
    e.add_argument("--fcpe-path", default="", help="reference fcpe.pt / fcpe_legacy.pt")
    e.add_argument("--hop-length", type=int, default=160,
                   help="frame hop of mangio-crepe and pyin")
    e.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    e.set_defaults(func=cmd_extract)

    t = sub.add_parser("train", help="train a voice from an extracted exp dir")
    t.add_argument("--exp-dir", required=True)
    t.add_argument("--version", default="v2", choices=["v1", "v2"])
    t.add_argument("--sample-rate", type=int, default=48000)
    t.add_argument("--epochs", type=int, default=200)
    t.add_argument("--batch-size", type=int, default=8,
                   help="rows per rank (the global batch is this x the ranks)")
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
                   help="delete old checkpoints, weights and TensorBoard logs first")
    t.add_argument("--vocoder", default="Default",
                   choices=["Default", "MRF HiFi-GAN", "RefineGAN"])
    t.add_argument("--no-pitch-guidance", dest="pitch_guidance", action="store_false",
                   help="train an f0-less model (plain HiFi-GAN decoder)")
    t.add_argument("--bf16", action="store_true",
                   help="bf16 forward/backward over fp32 master params")
    t.add_argument("--checkpointing", action="store_true",
                   help="recompute the G and D forwards in the backward")
    t.add_argument("--no-pretrained", action="store_true",
                   help="accepted for the JAX command line; nothing is downloaded")
    t.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    t.set_defaults(func=cmd_train)

    i = sub.add_parser("index", help="build the retrieval index of an extracted exp dir")
    i.add_argument("--exp-dir", required=True)
    i.add_argument("--version", default="v2", choices=["v1", "v2"])
    i.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    i.set_defaults(func=cmd_index)

    b = sub.add_parser("tensorboard", help="serve the TensorBoard of a training run")
    b.add_argument("--logdir", required=True)
    b.add_argument("--port", type=int, default=6006)
    b.set_defaults(func=cmd_tensorboard)
    c = sub.add_parser("convert", help="convert one utterance")
    c.add_argument("--input", required=True, help="wav or flac")
    c.add_argument("--output", required=True)
    c.add_argument("--model", required=True,
                   help="interchange .pth voice model, any of the reference's decoders")
    c.add_argument("--preset", default="",
                   help="preset JSON (the reference's keys); its values replace the flags'")
    c.add_argument("--split-audio", action="store_true",
                   help="convert the voiced pieces between silences")
    c.add_argument("--clean-audio", action="store_true",
                   help="spectral-gate the output (on --device)")
    c.add_argument("--clean-strength", type=float, default=0.7)
    c.add_argument("--formant-shifting", action="store_true",
                   help="shift the input's formants before conversion")
    c.add_argument("--formant-qfrency", type=float, default=0.8)
    c.add_argument("--formant-timbre", type=float, default=0.8)
    c.add_argument("--export-format", default="wav",
                   help="wav | flac (written here) | mp3/ogg/m4a (through ffmpeg)")
    _conversion_flags(c)
    c.set_defaults(func=cmd_convert)

    x = sub.add_parser("effects", help="apply the audio effects chain")
    x.add_argument("--input", required=True)
    x.add_argument("--output", required=True)
    from .utils.effects import EffectsSettings

    for fname, fdef in EffectsSettings.__dataclass_fields__.items():
        arg = "--" + fname.replace("_", "-")
        if isinstance(fdef.default, bool):
            x.add_argument(arg, dest=fname, action="store_true")
        else:
            x.add_argument(arg, dest=fname, type=type(fdef.default), default=fdef.default)
    x.set_defaults(func=cmd_effects)

    y = sub.add_parser("tts", help="text to speech (and conversion with --model)")
    y.add_argument("--text", default="")
    y.add_argument("--srt", default="", help="SRT file for timed synthesis")
    y.add_argument("--voice", default="en-US-EmmaMultilingualNeural",
                   help="edge voice name, or language code with --google")
    y.add_argument("--output", required=True, help="synthesized wav path")
    y.add_argument("--rate", type=int, default=0, help="speed delta %%")
    y.add_argument("--tts-pitch", type=int, default=0, help="pitch delta Hz")
    y.add_argument("--google", action="store_true",
                   help="use Google translate TTS instead of edge")
    y.add_argument("--model", default="",
                   help="voice model: also convert the TTS output")
    y.add_argument("--convert-output", default="tts_converted.wav")
    _conversion_flags(y)
    y.set_defaults(func=cmd_tts)

    f = sub.add_parser("fuse", help="blend two voice models of one architecture")
    f.add_argument("--model-a", required=True)
    f.add_argument("--model-b", required=True)
    f.add_argument("--output", required=True)
    f.add_argument("--ratio", type=float, default=0.5)
    f.set_defaults(func=cmd_fuse)

    n = sub.add_parser("info", help="a voice model's metadata, as JSON")
    n.add_argument("--model", required=True)
    n.set_defaults(func=cmd_info)

    o = sub.add_parser("export-onnx", help="export a .pth voice model to .onnx")
    o.add_argument("--model", required=True, help="reference-format .pth")
    o.add_argument("--output", required=True, help="the .onnx to write")
    o.add_argument("--static", action="store_true",
                   help="a graph of --max-frames capacity instead of the default "
                        "dynamic frame axis")
    o.add_argument("--max-frames", type=int, default=800,
                   help="frame capacity of a --static graph (a dynamic one serves any "
                        "length >= 21 frames)")
    o.set_defaults(func=cmd_export_onnx)

    ss = sub.add_parser("separate", help="vocals / instrumental with Demucs or MDX-Net")
    ss.add_argument("--model", required=True, help="demucs .th checkpoint, .yaml bag, or MDX .onnx")
    ss.add_argument("--input", required=True)
    ss.add_argument("--output-vocals", required=True)
    ss.add_argument("--output-instrumental", default="")
    ss.add_argument("--shifts", type=int, default=0)
    ss.add_argument("--invert-using-spec", action="store_true")
    ss.add_argument("--mdx-n-fft", type=int, default=6144,
                    help="MDX model FFT size (from the model registry)")
    ss.add_argument("--mdx-hop", type=int, default=1024)
    ss.add_argument("--mdx-compensate", type=float, default=1.035)
    ss.add_argument("--mdx-overlap", type=float, default=0.25)
    ss.add_argument("--mdx-denoise", action="store_true")
    ss.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ss.set_defaults(func=cmd_separate)

    sm = sub.add_parser("separate-music", help="full stem chain: separation + karaoke split "
                                               "+ dereverb (reference separator_music.py)")
    sm.add_argument("--input", required=True)
    sm.add_argument("--output", default="./audios")
    sm.add_argument("--model-name", default="HT-Normal",
                    help="registry name (HT-Normal, Kim_Vocal_1, ...) whose file is in "
                         "$RVC_TPU_ASSETS/models/uvr5, or a model path (.th/.yaml/.onnx)")
    sm.add_argument("--kara-model", default="Version-1")
    sm.add_argument("--reverb-model", default="Reverb_HQ")
    sm.add_argument("--backing", action="store_true")
    sm.add_argument("--reverb", action="store_true")
    sm.add_argument("--backing-reverb", action="store_true")
    sm.add_argument("--clean-audio", action="store_true")
    sm.add_argument("--clean-strength", type=float, default=0.7)
    sm.add_argument("--shifts", type=int, default=2)
    sm.add_argument("--sample-rate", type=int, default=44100)
    sm.add_argument("--export-format", default="wav")
    sm.add_argument("--mdx-denoise", action="store_true")
    sm.add_argument("--mdx-overlap", type=float, default=0.25)
    sm.add_argument("--mdx-hop", type=int, default=1024)
    sm.add_argument("--mdx-n-fft", type=int, default=6144)
    sm.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sm.set_defaults(func=cmd_separate_music)

    w = sub.add_parser("transcribe", help="Whisper speech recognition to JSON segments")
    w.add_argument("--model", required=True, help="whisper .pt")
    w.add_argument("--vocab", required=True, help="multilingual.tiktoken vocabulary file")
    w.add_argument("--input", required=True)
    w.add_argument("--output", required=True)
    w.add_argument("--language", default="en")
    w.add_argument("--word-timestamps", action="store_true")
    w.add_argument("--beam-size", type=int, default=None,
                   help="beam search width at temperature 0")
    w.add_argument("--patience", type=float, default=None, help="beam patience multiplier")
    w.add_argument("--best-of", type=int, default=None,
                   help="independent samples kept at temperature > 0")
    w.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    w.set_defaults(func=cmd_transcribe)

    dz = sub.add_parser("diarize-convert", help="multi-speaker conversion: diarize, then "
                                                "alternate two voice models per speaker")
    dz.add_argument("--input", required=True)
    dz.add_argument("--output", required=True)
    dz.add_argument("--model", required=True, help="voice model A")
    dz.add_argument("--model-b", default="", help="voice model B")
    dz.add_argument("--ecapa", required=True,
                    help="ECAPA-TDNN checkpoint, or a speechbrain directory with "
                         "hyperparams.yaml and embedding_model.ckpt")
    dz.add_argument("--whisper", default="",
                    help="whisper .pt for the segment boundaries (default: energy VAD)")
    dz.add_argument("--vocab", default="", help="tiktoken vocabulary (with --whisper)")
    _conversion_flags(dz)
    dz.set_defaults(func=cmd_diarize_convert)

    ed = sub.add_parser("edit", help="prompt-based audio editing by DDPM inversion (AudioLDM2)")
    ed.add_argument("--input-path", required=True)
    ed.add_argument("--output-path", default="./output.wav")
    ed.add_argument("--export-format", default="wav")
    ed.add_argument("--sample-rate", type=int, default=44100)
    ed.add_argument("--model", default="audioldm2-music",
                    choices=["audioldm2", "audioldm2-large", "audioldm2-music"])
    ed.add_argument("--source-prompt", default="")
    ed.add_argument("--target-prompt", default="")
    ed.add_argument("--steps", type=int, default=50)
    ed.add_argument("--cfg-scale-src", type=float, default=3.5)
    ed.add_argument("--cfg-scale-tar", type=float, default=12.0)
    ed.add_argument("--t-start", type=int, default=45)
    ed.add_argument("--save-compute", action="store_true", default=True)
    ed.add_argument("--toy-stack", action="store_true",
                    help="the self-contained toy latent stack (no pretrained weights)")
    ed.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ed.set_defaults(func=cmd_edit)
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
