#!/usr/bin/env bash
# Stage 1: train the speech encoder and adapter, the LLM frozen, on 8 GPUs
# of one host: the port's counterpart of scripts/train/stage1.sh (the
# reference's 8-GPU DeepSpeed ZeRO-2 recipe as 8 data ranks with every
# float leaf split over them, FSDP).
set -euo pipefail

llama_path=${LLAMA_PATH:?path to llama-3.1-8b-instruct-hf}
w2v2_path=${W2V2_PATH:?path to wav2_vec_vox_960h_pl.pt}
data_path=${DATA_PATH:?path to en-xx data dir}
save_dir=${SAVE_DIR:-runs/stage1}
lang=${TARGET_LANG:-German}

torchrun --standalone --nproc_per_node 8 -m infinisst_tpu_torch.train.main \
    --w2v2_path "${w2v2_path}" \
    --llm_path "${llama_path}" \
    --tokenizer_path "${llama_path}" \
    --data_path "${data_path}" \
    --data_split_train 'train_nospeaker_traj_30_filtered' \
    --data_split_eval 'dev_nospeaker_traj_30_filtered' \
    --source_lang "English" \
    --target_lang "${lang}" \
    --trajectory 4 \
    --trajectory_max_multiplier 4 \
    --trajectory_prob_aug 0.0 \
    --stage 1 \
    --train_bsz 1800 \
    --eval_bsz 1800 \
    --bsz_sent 2 \
    --learning_rate 2e-4 \
    --warmup_steps 1000 \
    --max_epochs 6 \
    --grad_acc_steps 4 \
    --clip_norm 1.0 \
    --save_dir "${save_dir}" \
    --log_step 5 \
    --eval_step 200 \
    --n_data 8 --n_model 1 --zero True
