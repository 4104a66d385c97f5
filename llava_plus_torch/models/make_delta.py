"""Write delta weights: the target's language model minus the base's, so
that a model over a license-encumbered base can be distributed as a delta
(the reference's ``llava/model/make_delta.py``; the port's counterpart of
``llava_plus_tpu/models/make_delta.py``).

    python -m llava_plus_torch.models.make_delta \\
        --base <base dir> --target <full llava dir> --delta <out dir>
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--base", type=str, required=True)
    parser.add_argument("--target", type=str, required=True)
    parser.add_argument("--delta", type=str, required=True)
    args = parser.parse_args(argv)

    from llava_plus_torch.models.builder import load_pretrained_model
    from llava_plus_torch.train.checkpoint import export_hf_llava, make_delta

    _, base_params, _, _, _ = load_pretrained_model(args.base)
    tok_t, target_params, cfg, _, _ = load_pretrained_model(args.target)
    delta_lm = make_delta(target_params, base_params["language_model"])
    export_hf_llava(dict(target_params, language_model=delta_lm), cfg, args.delta, tok_t)
    print(f"wrote delta -> {args.delta}")


if __name__ == "__main__":
    main()
