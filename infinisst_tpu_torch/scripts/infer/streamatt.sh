#!/usr/bin/env bash
# The StreamAtt / AlignAtt baselines with the offline checkpoint, on one
# GPU: the port's counterpart of scripts/infer/streamatt.sh (the
# reference's frame_num array is the FRAME env var here).
set -euo pipefail

ckpt=${STATE_DICT:?path to offline pytorch_model.bin}
llama_path=${LLAMA_PATH:?path to llama tokenizer/config dir}
data=${DATA:?dir with tst-COMMON_full.{source,target}}
frame=${FRAME:-1}
agent=${AGENT:-streamatt}
lang=${TARGET_LANG:-German}
tok=13a; unit=word
if [ "${lang}" == "Chinese" ]; then tok=zh; unit=char; fi

python -m infinisst_tpu_torch.agents.cli \
    --agent "${agent}" \
    --source "${data}/tst-COMMON_full.source" \
    --target "${data}/tst-COMMON_full.target" \
    --output "out/${agent}_f${frame}" \
    --source-segment-size 960 \
    --source-lang English --target-lang "${lang}" \
    --state-dict-path "${ckpt}" \
    --model-name "${llama_path}" \
    --frame-num "${frame}" --attn-layer 14 \
    --text-preserve-num 40 --min-speech-duration 10 \
    --max-speech-duration 28.8 \
    --beam 4 --no-repeat-ngram-size 5 --repetition-penalty 1.2 \
    --eval-latency-unit "${unit}" --sacrebleu-tokenizer "${tok}"
