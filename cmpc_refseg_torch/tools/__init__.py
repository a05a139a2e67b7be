"""The port's user-facing programs beside the model: the DeepLab-ResNet VOC
pretraining pipeline (`pretrain_backbone`, its host side `voc` and the
caffemodel ingestion `kaffe`), the scaled convergence proof
(`convergence_proof`) and the visualisation dumps (`visualize`).  Each
runs as ``python -m cmpc_refseg_torch.tools.<name>``, on the CUDA device
unless asked for the CPU."""
