#!/usr/bin/env bash
# Streaming eval of the InfiniSST agent on full talks, on one GPU: the
# port's counterpart of scripts/infer/infinisst.sh (the reference's SLURM
# array over the latency multiplier is the MULT env var here).
set -euo pipefail

ckpt=${STATE_DICT:?path to pytorch_model.bin}
llama_path=${LLAMA_PATH:?path to llama tokenizer/config dir}
data=${DATA:?dir with tst-COMMON_full.{source,target}}
mult=${MULT:-1}
lang=${TARGET_LANG:-German}
tok=13a; unit=word
if [ "${lang}" == "Chinese" ]; then tok=zh; unit=char; fi

python -m infinisst_tpu_torch.agents.cli \
    --agent infinisst \
    --source "${data}/tst-COMMON_full.source" \
    --target "${data}/tst-COMMON_full.target" \
    --output "out/infinisst_m${mult}" \
    --latency-multiplier "${mult}" \
    --source-lang English --target-lang "${lang}" \
    --min-start-sec 0 \
    --state-dict-path "${ckpt}" \
    --model-name "${llama_path}" \
    --block-size 48 --max-cache-size 576 --xpos 0 \
    --max-llm-cache-size 1000 --always-cache-system-prompt \
    --beam 4 --no-repeat-ngram-lookback 100 --no-repeat-ngram-size 5 \
    --repetition-penalty 1.2 \
    --eval-latency-unit "${unit}" --sacrebleu-tokenizer "${tok}"
