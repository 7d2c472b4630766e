from emr2a_tpu_torch.pipelines.step1_manifest.build_manifest import main

if __name__ == "__main__":
    main()
