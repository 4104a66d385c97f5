"""Apply delta weights to a base model: the full checkpoint back from base +
delta (the reference's ``llava/model/apply_delta.py``; the port's
counterpart of ``llava_plus_tpu/models/apply_delta.py``).

    python -m llava_plus_torch.models.apply_delta \\
        --base <base dir> --delta <delta dir> --target <out dir>
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--base", type=str, required=True)
    parser.add_argument("--delta", type=str, required=True)
    parser.add_argument("--target", type=str, required=True)
    args = parser.parse_args(argv)

    from llava_plus_torch.models.builder import load_pretrained_model
    from llava_plus_torch.train.checkpoint import apply_delta, export_hf_llava

    _, base_params, _, _, _ = load_pretrained_model(args.base)
    tok_d, delta_params, cfg, _, _ = load_pretrained_model(args.delta)
    lm = apply_delta(delta_params["language_model"], base_params["language_model"])
    export_hf_llava(dict(delta_params, language_model=lm), cfg, args.target, tok_d)
    print(f"wrote reconstructed model -> {args.target}")


if __name__ == "__main__":
    main()
