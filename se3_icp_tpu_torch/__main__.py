from se3_icp_tpu_torch.cli import main

main()
