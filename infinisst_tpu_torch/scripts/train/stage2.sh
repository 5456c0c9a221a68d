#!/usr/bin/env bash
# Stage 2: the w2v2 body frozen, the adapter and LLM trained from the
# stage-1 weights, on 8 GPUs of one host: the port's counterpart of
# scripts/train/stage2.sh, with its hyperparameters and its mesh (2 data
# ranks with FSDP x 4 tensor-parallel ranks; `python -m
# infinisst_tpu_torch.tools.memplan --world 8` reckons every mesh of 8).
set -euo pipefail

llama_path=${LLAMA_PATH:?path to llama-3.1-8b-instruct-hf}
w2v2_path=${W2V2_PATH:?path to wav2_vec_vox_960h_pl.pt}
data_path=${DATA_PATH:?path to en-xx data dir}
stage1_bin=${STAGE1_BIN:?stage-1 exported bin}
save_dir=${SAVE_DIR:-runs/stage2}
lang=${TARGET_LANG:-German}

torchrun --standalone --nproc_per_node 8 -m infinisst_tpu_torch.train.main \
    --w2v2_path "${w2v2_path}" \
    --llm_path "${llama_path}" \
    --tokenizer_path "${llama_path}" \
    --sllm_weight_path "${stage1_bin}" \
    --data_path "${data_path}" \
    --data_split_train 'train_nospeaker_traj_30_filtered' \
    --data_split_eval 'dev_nospeaker_traj_30_filtered' \
    --source_lang "English" \
    --target_lang "${lang}" \
    --trajectory 4 \
    --trajectory_max_multiplier 4 \
    --stage 2 \
    --train_bsz 1800 \
    --eval_bsz 1800 \
    --bsz_sent 2 \
    --learning_rate 7e-6 \
    --warmup_steps 100 \
    --max_epochs 1 \
    --grad_acc_steps 4 \
    --clip_norm 1.0 \
    --save_dir "${save_dir}" \
    --n_data 2 --n_model 4 --zero True
