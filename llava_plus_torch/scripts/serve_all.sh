#!/bin/bash
# Bring up the full serving topology on one machine (controller + LLM worker
# + fake tool workers for smoke testing). Ports mirror the reference layout.

python -m llava_plus_torch.serve.controller --host 0.0.0.0 --port 21001 &
sleep 2
python -m llava_plus_torch.serve.model_worker \
    --controller-address http://localhost:21001 \
    --port 21002 --worker-address http://localhost:21002 \
    --model-path "$1" &
wait
