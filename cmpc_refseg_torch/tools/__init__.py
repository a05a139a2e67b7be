"""The port's user-facing programs beside the model: the DeepLab-ResNet VOC
pretraining pipeline (`pretrain_backbone`, its host side `voc` and the
caffemodel ingestion `kaffe`), the scaled convergence proof
(`convergence_proof`), the visualisation dumps (`visualize`), the
reference's TF-checkpoint converter (`convert_tf_checkpoint`, which needs
TensorFlow only to read a file) and the accuracy-parity dress rehearsal
(`parity_rehearsal`).  Each runs as
``python -m cmpc_refseg_torch.tools.<name>``, on the CUDA device unless
asked for the CPU; the converter's command line runs on the host (it
writes files)."""
