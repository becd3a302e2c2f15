"""pci (twin: ``gpu_feature_discovery_tpu/pci/``): sysfs scan of NVIDIA
display functions and the PCI capability walker."""
