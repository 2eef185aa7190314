"""Command-line interface (port of ``vietvoice_tts_tpu/cli.py``).

    python -m vietvoice_tts_tpu_torch "Xin chào Việt Nam" out.wav

Same surface as the reference CLI (``vietvoicetts/cli.py``):
positional ``text output`` non-interactive mode with voice/reference/sampler
flags, and an interactive menu (launched when no args are given) with voice
selection, reference-audio setup including a filterable sample browser with
playback, performance/model/audio sections, and a confirmation screen
writing to ``output/<name>.wav``. Against the JAX package's CLI:
``--no-pallas`` is ``--no-kernels`` and ``--device`` (default ``cuda``) says
where the model runs. Without ``--device cpu`` and without a card the CLI
exits non-zero and synthesizes nothing. After a request it prints the device
and how often each CUDA kernel was launched.

``--mesh-data`` / ``--mesh-model`` above 1 run the model on a mesh of ranks
(``parallel/``): launch one process per rank, every one with the same
command, e.g. ``torchrun --nproc-per-node 2 -m vietvoice_tts_tpu_torch
"Xin chào" out.wav --mesh-model 2``. Rank 0 alone writes the WAV and
prints. Outside such a launch the CLI exits 1 with a message that names
``torchrun``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import Any, Dict, Union

from .config import (
    MODEL_AREA,
    MODEL_EMOTION,
    MODEL_GENDER,
    MODEL_GROUP,
    ModelConfig,
)


class Colors:
    RESET = "\033[0m"
    BOLD = "\033[1m"
    GREEN = "\033[92m"
    YELLOW = "\033[93m"
    RED = "\033[91m"
    CYAN = "\033[96m"
    MAGENTA = "\033[95m"
    BLUE = "\033[94m"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vietvoice-tts",
        description="VietVoice TTS (PyTorch / CUDA) - Vietnamese Text-to-Speech",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="""
Examples:
  vietvoice-tts "Xin chào Việt Nam" output.wav --gender female --area northern
  vietvoice-tts "Hello" out.wav --reference-audio ref.wav --reference-text "Hello"

Interactive mode: run without arguments.
""",
    )
    parser.add_argument("text", nargs="?", help="Text to synthesize")
    parser.add_argument("output", nargs="?", help="Output audio file path")

    parser.add_argument("--gender", choices=MODEL_GENDER, help="Voice gender")
    parser.add_argument("--group", choices=MODEL_GROUP, help="Voice group/style")
    parser.add_argument("--area", choices=MODEL_AREA, help="Voice area/accent")
    parser.add_argument("--emotion", choices=MODEL_EMOTION, help="Voice emotion")
    parser.add_argument(
        "--sample-iteration",
        type=int,
        help="Which matching catalog sample to use (0-based)",
    )

    parser.add_argument("--reference-audio", help="Path to reference audio file")
    parser.add_argument(
        "--reference-text", help="Text corresponding to reference audio"
    )

    parser.add_argument("--speed", type=float, default=0.9, help="Speech speed")
    parser.add_argument(
        "--random-seed",
        type=int,
        default=9527,
        help="Random seed (keeps the same voice across runs)",
    )

    parser.add_argument("--model-cache-dir", help="Directory of the weight pack")
    parser.add_argument("--nfe-step", type=int, default=32, help="Number of NFE steps")
    parser.add_argument("--fuse-nfe", type=int, default=1, help="Fuse NFE steps")
    parser.add_argument(
        "--cfg-strength", type=float, default=2.0, help="Classifier-free guidance scale"
    )
    parser.add_argument(
        "--nfe-uncond-interval",
        type=int,
        default=1,
        help="CFG-cache acceleration: refresh the unconditional branch "
        "every k-th NFE eval (1 = exact; 2 cuts DiT compute ~25%%, "
        "quality should be judged on real weights first)",
    )
    parser.add_argument(
        "--nfe-deep-cache-interval",
        type=int,
        default=1,
        help="Deep-block-cache acceleration: run the full DiT depth every "
        "r-th NFE eval and reuse the deep trunk's contribution in between "
        "(1 = exact; judge quality on real weights first; mutually "
        "exclusive with --nfe-uncond-interval)",
    )
    parser.add_argument(
        "--nfe-deep-cache-blocks",
        type=int,
        default=7,
        help="Shallow blocks re-evaluated on cached evals (of dit depth)",
    )

    parser.add_argument(
        "--cross-fade-duration", type=float, default=0.1, help="Cross-fade seconds"
    )
    # Note: the reference CLI defaults max-chunk-duration to 15.0 while its
    # config default is 20.0 (reference cli.py:78 vs model_config.py:47);
    # we keep the CLI-facing 15.0 for drop-in compatibility.
    parser.add_argument(
        "--max-chunk-duration", type=float, default=15.0, help="Max chunk seconds"
    )
    parser.add_argument(
        "--min-target-duration", type=float, default=1.0, help="Min target seconds"
    )

    # Device runtime (replaces the reference's ONNX-runtime thread flags).
    parser.add_argument(
        "--compute-dtype",
        choices=["bfloat16", "float32"],
        default="bfloat16",
        help="Matmul/activation dtype on device",
    )
    parser.add_argument(
        "--max-batch-size", type=int, default=8, help="Max chunks per device batch"
    )
    parser.add_argument(
        "--no-kernels",
        action="store_true",
        help="Run the plain PyTorch attention instead of the CUDA kernels",
    )
    parser.add_argument(
        "--mesh-data", type=int, default=1, help="Data-parallel mesh axis size"
    )
    parser.add_argument(
        "--mesh-model", type=int, default=1, help="Model-parallel mesh axis size"
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="Where the model runs: cuda (default; fails without a card), "
        "cuda:<index> or cpu",
    )
    parser.add_argument(
        "--warmup",
        action="store_true",
        help="Run every configured (batch, bucket) shape once before "
        "synthesis (builds the kernels, creates the library handles and "
        "buffers; useful before serving)",
    )
    return parser


def create_config(args: Union[argparse.Namespace, Dict[str, Any]]) -> ModelConfig:
    """Build a ModelConfig from argparse Namespace or interactive dict."""
    if isinstance(args, dict):
        mapping = {
            "nfe_step": args.get("nfe_step"),
            "fuse_nfe": args.get("fuse_nfe"),
            "speed": args.get("speed"),
            "random_seed": args.get("random_seed"),
            "cfg_strength": args.get("cfg_strength"),
            "cross_fade_duration": args.get("cross_fade_duration"),
            "max_chunk_duration": args.get("max_chunk_duration"),
            "min_target_duration": args.get("min_target_duration"),
            "model_cache_dir": args.get("model_cache_dir"),
            "compute_dtype": args.get("compute_dtype"),
            "max_batch_size": args.get("max_batch_size"),
            "device": args.get("device"),
        }
        return _config_for_pack({k: v for k, v in mapping.items() if v is not None})
    kwargs = dict(
        nfe_step=args.nfe_step,
        fuse_nfe=args.fuse_nfe,
        nfe_uncond_interval=args.nfe_uncond_interval,
        nfe_deep_cache_interval=args.nfe_deep_cache_interval,
        nfe_deep_cache_blocks=args.nfe_deep_cache_blocks,
        speed=args.speed,
        random_seed=args.random_seed,
        cfg_strength=args.cfg_strength,
        cross_fade_duration=args.cross_fade_duration,
        max_chunk_duration=args.max_chunk_duration,
        min_target_duration=args.min_target_duration,
        compute_dtype=args.compute_dtype,
        max_batch_size=args.max_batch_size,
        use_kernels=not args.no_kernels,
        mesh_data_axis=args.mesh_data,
        mesh_model_axis=args.mesh_model,
        device=args.device,
    )
    if args.model_cache_dir:
        kwargs["model_cache_dir"] = args.model_cache_dir
    return _config_for_pack(kwargs)


def _config_for_pack(kwargs: Dict[str, Any]) -> ModelConfig:
    """ModelConfig(**kwargs), with the architecture of the weight pack that
    the configuration names where that pack exists already: a pack converted
    at other widths than the defaults loads without further flags."""
    config = ModelConfig(**kwargs)
    pack = Path(config.model_path)
    if not (pack / "model_meta.json").exists():
        return config
    from .runtime.session import config_from_pack

    kwargs = {k: v for k, v in kwargs.items() if k != "model_cache_dir"}
    return config_from_pack(pack, **kwargs)


def kernel_launches() -> dict:
    """How often each CUDA kernel wrapper has launched its kernel in this
    process (0 everywhere on the CPU, where the plain versions run)."""
    from .ops.kernels import adaln_norm, flash_attention, fused_rope_attention

    return {
        "fused_qkv_rope_attention": fused_rope_attention.launches,
        "flash_attention": flash_attention.launches,
        "adaln_norm": adaln_norm.launches,
    }


def _print_device_report(config: ModelConfig, core) -> None:
    import torch

    device = torch.device(config.device)
    name = f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""
    print(f"Device: {device.type}{name}")
    print(
        "Kernel launches: "
        + ", ".join(f"{k}={v}" for k, v in kernel_launches().items())
    )
    print(f"Chunk graphs: {core.graph_captures} captured, {core.graph_replays} replays")


def main() -> None:
    parser = build_parser()
    args = parser.parse_args()

    if len(sys.argv) == 1:
        run_interactive_mode()
        return

    if not args.text or not args.output:
        parser.error("text and output arguments are required in non-interactive mode")
    if args.reference_audio and not args.reference_text:
        parser.error("--reference-text is required when using --reference-audio")
    if args.reference_text and not args.reference_audio:
        parser.error("--reference-audio is required when using --reference-text")

    try:
        from .client import TTSApi
        from .parallel.mesh import launch_mesh

        config = create_config(args)
        mesh = launch_mesh(args.mesh_data, args.mesh_model)
        lead = mesh is None or mesh.rank == 0  # the rank that writes and prints
        api = TTSApi(config, mesh=mesh)
        if args.warmup:
            if lead:
                print("Warming up (running every batch and bucket shape once)...")
            api.engine.warmup()
        request = dict(
            text=args.text,
            gender=args.gender,
            group=args.group,
            area=args.area,
            emotion=args.emotion,
            sample_iteration=args.sample_iteration,
            reference_audio=args.reference_audio,
            reference_text=args.reference_text,
        )
        if lead:
            duration = api.synthesize_to_file(output_path=args.output, **request)
        else:  # the same batches, in lockstep; rank 0 writes the file
            api.synthesize(**request)
        if lead:
            print(f"Synthesis complete! Generation took {duration:.2f}s")
            print(f"Output saved to: {args.output}")
            _print_device_report(config, api.engine.engine_core)
    except Exception as e:  # noqa: BLE001 — CLI boundary
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)


# ---------------------------------------------------------------------------
# Interactive mode
# ---------------------------------------------------------------------------


def _default_settings() -> Dict[str, Any]:
    # Read off the dataclass, not off an instance: constructing the default
    # config asks for the card.
    default = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    keys = (
        "gender", "group", "area", "emotion", "speed", "random_seed", "nfe_step",
        "fuse_nfe", "cfg_strength", "cross_fade_duration", "max_chunk_duration",
        "min_target_duration", "compute_dtype", "max_batch_size", "device",
    )
    return {
        **{k: default[k] for k in keys},
        "reference_audio": None,
        "reference_text": None,
        "model_cache_dir": None,
    }


def _ask(prompt: str, default=None, cast=str):
    raw = input(
        f"{Colors.GREEN}{prompt}"
        + (f" [{default}]" if default is not None else "")
        + f": {Colors.RESET}"
    ).strip()
    if not raw:
        return default
    try:
        return cast(raw)
    except ValueError:
        print(f"{Colors.RED}Invalid value, keeping {default}{Colors.RESET}")
        return default


def _select_from_list(name: str, options: list, current):
    print(f"\n{Colors.CYAN}{name}{Colors.RESET} (current: {current})")
    print("  0. (keep current)")
    for i, opt in enumerate(options, 1):
        print(f"  {i}. {opt}")
    print(f"  {len(options) + 1}. (none)")
    choice = _ask("Select", 0, int)
    if choice is None or choice == 0:
        return current
    if 1 <= choice <= len(options):
        return options[choice - 1]
    if choice == len(options) + 1:
        return None
    print(f"{Colors.RED}Out of range; keeping current.{Colors.RESET}")
    return current


# (section title, [(settings key, prompt, cast)])
_SECTIONS = [
    (
        "Performance Tuning",
        [
            ("speed", "Speech speed (0.1-5.0)", float),
            ("nfe_step", "NFE steps (1-100)", int),
            ("fuse_nfe", "Fused NFE steps", int),
            ("cfg_strength", "CFG strength", float),
        ],
    ),
    (
        "Model Configuration",
        [
            ("model_cache_dir", "Weight pack directory", str),
            ("random_seed", "Random seed", int),
        ],
    ),
    (
        "Audio Processing",
        [
            ("cross_fade_duration", "Cross-fade duration (s)", float),
            ("max_chunk_duration", "Max chunk duration (s)", float),
            ("min_target_duration", "Min target duration (s)", float),
        ],
    ),
    (
        "Device Runtime",
        [
            ("compute_dtype", "Compute dtype (bfloat16/float32)", str),
            ("max_batch_size", "Max device batch size", int),
            ("device", "Device (cuda/cpu)", str),
        ],
    ),
]


def _edit_section(settings: Dict[str, Any], title: str, fields) -> Dict[str, Any]:
    print(f"\n{Colors.CYAN}{Colors.BOLD}{title}{Colors.RESET}")
    for key, prompt, cast in fields:
        settings[key] = _ask(prompt, settings.get(key), cast)
    return settings


def _edit_voice(settings: Dict[str, Any]) -> Dict[str, Any]:
    print(f"\n{Colors.CYAN}{Colors.BOLD}Voice Selection{Colors.RESET}")
    settings["gender"] = _select_from_list("Gender", MODEL_GENDER, settings["gender"])
    settings["group"] = _select_from_list("Group", MODEL_GROUP, settings["group"])
    settings["area"] = _select_from_list("Area", MODEL_AREA, settings["area"])
    settings["emotion"] = _select_from_list("Emotion", MODEL_EMOTION, settings["emotion"])
    return settings


def _browse_reference_samples(settings: Dict[str, Any]) -> Dict[str, Any]:
    """Filterable catalog browser with optional playback.

    The bundled catalog lists the reference's full 239 voices even before
    the real clips arrive with the weight tarball, so rows whose clip is
    not present locally are MARKED and cannot be selected — applying a
    nonexistent path would only fail later inside synthesis."""
    from .reference_samples import (
        catalog_audio_bases,
        filter_samples,
        get_sample_path,
        load_reference_samples,
        play_sample,
    )

    bases = catalog_audio_bases()  # resolved once; per-row glob is wasteful
    samples = load_reference_samples()
    if not samples:
        print(f"{Colors.RED}No reference sample catalog found.{Colors.RESET}")
        return settings

    gender = _select_from_list("Filter gender", MODEL_GENDER, None)
    area = _select_from_list("Filter area", MODEL_AREA, None)
    emotion = _select_from_list("Filter emotion", MODEL_EMOTION, None)
    matches = filter_samples(samples, gender=gender, area=area, emotion=emotion)
    if not matches:
        print(f"{Colors.YELLOW}No samples match those filters.{Colors.RESET}")
        return settings

    # Paged listing: the real catalog has 239 rows, so a single filter can
    # easily match more than one screenful (the reference lists everything at
    # once, reference_samples browser in cli.py; we page at 20).
    page_size = 20
    n_pages = (len(matches) + page_size - 1) // page_size
    page_no = 0
    sample = None
    while sample is None:
        start = page_no * page_size
        page = matches[start : start + page_size]
        print(
            f"\n  {len(matches)} matching sample(s) — page {page_no + 1}/{n_pages}"
        )
        for i, s in enumerate(page, 1):
            missing = (
                ""
                if get_sample_path(s, bases).exists()
                else f" {Colors.YELLOW}[clip not local]{Colors.RESET}"
            )
            print(
                f"  {i:2d}. {s.filename} [{s.gender}/{s.group}/{s.area}/{s.emotion}] "
                f"{s.text[:40]}{missing}"
            )
        nav = "; n = next page, p = previous page" if n_pages > 1 else ""
        raw = _ask(f"Select sample (1-{len(page)}, 0 to cancel{nav})", "0")
        token = (raw or "0").strip().lower()
        if token == "n" and n_pages > 1:
            page_no = (page_no + 1) % n_pages
            continue
        if token == "p" and n_pages > 1:
            page_no = (page_no - 1) % n_pages
            continue
        try:
            idx = int(token)
        except ValueError:
            continue
        if not idx:
            return settings
        if 1 <= idx <= len(page):
            candidate = page[idx - 1]
            if not get_sample_path(candidate, bases).exists():
                print(
                    f"{Colors.YELLOW}That voice's clip is not in the local "
                    "pack (clips arrive with the real weight tarball) — "
                    f"pick a row without the marker.{Colors.RESET}"
                )
                continue
            sample = candidate
    if (_ask("Play sample? (y/n)", "n") or "n").lower().startswith("y"):
        play_sample(sample)
    settings["reference_audio"] = str(get_sample_path(sample, bases))
    settings["reference_text"] = sample.text
    # Explicit filters conflict with reference audio; clear them.
    settings["gender"] = settings["group"] = settings["area"] = settings["emotion"] = None
    return settings


def _edit_reference_audio(settings: Dict[str, Any]) -> Dict[str, Any]:
    print(f"\n{Colors.CYAN}{Colors.BOLD}Reference Audio{Colors.RESET}")
    print("  1. Browse built-in samples")
    print("  2. Use my own audio file")
    print("  3. Clear reference audio")
    choice = _ask("Select", 0, int)
    if choice == 1:
        return _browse_reference_samples(settings)
    if choice == 2:
        path = _ask("Path to reference audio", settings.get("reference_audio"))
        if path and not Path(path).exists():
            print(f"{Colors.RED}File not found: {path}{Colors.RESET}")
            return settings
        text = _ask("Reference transcript", settings.get("reference_text"))
        settings["reference_audio"] = path
        settings["reference_text"] = text
        if path and text:
            settings["gender"] = settings["group"] = None
            settings["area"] = settings["emotion"] = None
    elif choice == 3:
        settings["reference_audio"] = settings["reference_text"] = None
    return settings


def _display_menu(settings: Dict[str, Any]) -> None:
    print(f"\n{Colors.CYAN}{Colors.BOLD}Main Menu{Colors.RESET}")
    preview = settings["text"][:50] + ("..." if len(settings["text"]) > 50 else "")
    print(f"  Text:   {Colors.GREEN}{preview}{Colors.RESET}")
    print(f"  Output: {Colors.GREEN}{settings['output']}{Colors.RESET}")
    voice = ", ".join(
        f"{k}: {settings[k]}"
        for k in ("gender", "group", "area", "emotion")
        if settings[k]
    )
    if voice:
        print(f"  Voice:  {Colors.YELLOW}{voice}{Colors.RESET}")
    if settings["reference_audio"] and settings["reference_text"]:
        print(f"  Reference: {Colors.MAGENTA}enabled{Colors.RESET}")
    print(f"\n{Colors.CYAN}Options:{Colors.RESET}")
    print("  1. Voice Selection")
    print("  2. Reference Audio")
    for i, (title, _) in enumerate(_SECTIONS, 3):
        print(f"  {i}. {title}")
    print("  7. Confirm and Synthesize")


def _confirm_and_synthesize(settings: Dict[str, Any]) -> bool:
    from .client import TTSApi

    out_name = settings["output"]
    if not out_name.endswith(".wav"):
        out_name += ".wav"
    out_path = Path("output") / out_name

    print(f"\n{Colors.CYAN}{Colors.BOLD}Confirm Synthesis{Colors.RESET}")
    print(f"  Output file: {out_path}")
    if not (_ask("Proceed? (y/n)", "y") or "y").lower().startswith("y"):
        return False

    try:
        config = create_config(settings)
        api = TTSApi(config)
        duration = api.synthesize_to_file(
            text=settings["text"],
            output_path=str(out_path),
            gender=settings["gender"],
            group=settings["group"],
            area=settings["area"],
            emotion=settings["emotion"],
            reference_audio=settings["reference_audio"],
            reference_text=settings["reference_text"],
        )
        print(f"{Colors.GREEN}Done in {duration:.2f}s -> {out_path}{Colors.RESET}")
        return True
    except Exception as e:  # noqa: BLE001 — CLI boundary
        print(f"{Colors.RED}Synthesis failed: {e}{Colors.RESET}")
        return False


def run_interactive_mode() -> None:
    print(f"\n{Colors.CYAN}{Colors.BOLD}VietVoice TTS (PyTorch / CUDA) — Interactive Mode{Colors.RESET}")
    print(f"{Colors.GREEN}Welcome to the interactive text-to-speech synthesizer!{Colors.RESET}\n")

    text = ""
    while not text:
        text = (_ask("Enter text to synthesize") or "").strip()
        if not text:
            print(f"{Colors.RED}Text cannot be empty.{Colors.RESET}")
    output = (_ask("Output filename", "output") or "output").strip()

    settings = {"text": text, "output": output}
    settings.update(_default_settings())

    while True:
        _display_menu(settings)
        choice = (_ask("Select option [1-7]", "") or "").strip()
        if choice == "1":
            settings = _edit_voice(settings)
        elif choice == "2":
            settings = _edit_reference_audio(settings)
        elif choice in ("3", "4", "5", "6"):
            title, fields = _SECTIONS[int(choice) - 3]
            settings = _edit_section(settings, title, fields)
        elif choice == "7":
            if _confirm_and_synthesize(settings):
                break
        else:
            print(f"{Colors.RED}Invalid choice. Please select 1-7.{Colors.RESET}")


if __name__ == "__main__":
    main()
